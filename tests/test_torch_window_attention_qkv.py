"""The fused-qkv window attention of the port (K16 forward, K17 backward) against the
JAX package on the CPU, the rule by which the window-attention and decoder-tail
kernels take their operands, and the scaled-dot route of ``WindowAttention``.

The plain versions are held against ``fused_window_attention_qkv`` run in interpret
mode (``wblk=4``) and its ``jax.vjp``, on the same numpy inputs, ws 16, 2 heads, C 32:

- float32: forward within 2e-5 absolute and relative; every gradient, normalized by
  its largest entry, within 5e-6 (the same f32 math in another order).
- bfloat16: relative L2 <= 5e-4 forward and <= 2e-3 for every gradient.  Both sides
  round at the same points (qkv after the f32 bias add; q_hat, k_hat for cosine; p;
  ds before the q/k products, scaled-dot multiplying sm_scale in after them; dqkv
  before dx, dW and db; the weight gradients to bf16 as the JAX custom VJP returns
  them), and differ only where f32 sums taken in another order flip a rounding:
  measured <= 1.3e-4 forward and <= 8.5e-4 backward (the bf16-rounded weight
  gradients).  Leaving dqkv unrounded before dx, dW and db moves them by up to 2.7e-3,
  adding the qkv bias after the rounding by up to 6.3e-3: the bounds tell them apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch.models.layers import LayerNorm, WindowAttention
from heal_swin_torch.ops import final_head as fh
from heal_swin_torch.ops import window_attention as wa
from heal_swin_tpu.ops.window_attention import fused_window_attention_qkv

F32_FWD = dict(rtol=2e-5, atol=2e-5)
F32_GRAD = 5e-6
BF16_FWD = 5e-4
BF16_GRAD = 2e-3
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
WS, H, C, NW = 16, 2, 32, 16
T = WS * NW
SM_SCALE = 0.18
CASES = [(c, qb, m, b) for c in (True, False) for qb in (True, False) for m in (True, False)
         for b in (True, False)]
CASE_IDS = [f"{'cos' if c else 'dot'}-{'qb' if qb else 'noqb'}-{'mask' if m else 'nomask'}-"
            f"{'bias' if b else 'nobias'}" for c, qb, m, b in CASES]


def _t(a):
    return torch.from_numpy(np.array(a))


def _operands(seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.normal(size=(T, C)).astype(f),
        wq=(rng.normal(size=(C, 3 * C)) * 0.1).astype(f),
        bq=(rng.normal(size=(3 * C,)) * 0.1).astype(f),
        groups=rng.integers(0, 3, (NW, WS)).astype(np.int32),
        bias=rng.normal(size=(H, WS, WS)).astype(f),
        ls=np.exp(rng.normal(size=H)).astype(f),
        dout=rng.normal(size=(T, C)).astype(f),
    )


def _jax_fn(o, use_cos, qkv_bias, has_mask, has_bias):
    """(fn, primal names): the Pallas kernel in interpret mode on the differentiable
    operands this case has."""
    names = ["x", "wq"] + ["bq"] * qkv_bias + ["bias"] * has_bias + ["ls"] * use_cos

    def fn(*args):
        a = dict(zip(names, args))
        return fused_window_attention_qkv(
            a["x"], a["wq"], a.get("bq"), jnp.asarray(o["groups"]), a.get("bias"),
            a.get("ls"), ws=WS, num_heads=H, use_cos=use_cos, sm_scale=SM_SCALE,
            has_mask=has_mask, wblk=4, interpret=True)

    return fn, names


def _port_args(o, tdt, use_cos, qkv_bias, has_bias):
    return (_t(o["x"]).to(tdt), _t(o["wq"]).to(tdt), _t(o["bq"]).to(tdt) if qkv_bias else None,
            _t(o["groups"]), _t(o["bias"]) if has_bias else None,
            _t(o["ls"]) if use_cos else None)


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("use_cos,qkv_bias,has_mask,has_bias", CASES, ids=CASE_IDS)
def test_qkv_plain_matches_pallas(use_cos, qkv_bias, has_mask, has_bias, dtype):
    """K16's plain version: x and the qkv weights in ``dtype``, bias and scales f32."""
    jdt, tdt = DTYPES[dtype]
    o = _operands(3)
    fn, names = _jax_fn(o, use_cos, qkv_bias, has_mask, has_bias)
    want = np.asarray(fn(*(jnp.asarray(o[k], jdt if k in ("x", "wq", "bq") else None)
                           for k in names)).astype(jnp.float32))
    got = wa.window_attention_qkv_plain(
        *_port_args(o, tdt, use_cos, qkv_bias, has_bias), ws=WS, num_heads=H,
        use_cos=use_cos, sm_scale=SM_SCALE, has_mask=has_mask)
    assert got.dtype == tdt and got.shape == (T, C)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_FWD)
    else:
        assert np.isfinite(got).all() and _rel_l2(got, want) <= BF16_FWD


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("use_cos,qkv_bias,has_mask,has_bias", CASES, ids=CASE_IDS)
def test_qkv_bwd_plain_matches_pallas_vjp(use_cos, qkv_bias, has_mask, has_bias, dtype):
    """K17's plain version: dx, and the gradients of Wqkv and bqkv (in the compute dtype,
    as the JAX custom VJP returns them), of the bias and of the logit scale."""
    jdt, tdt = DTYPES[dtype]
    o = _operands(4)
    fn, names = _jax_fn(o, use_cos, qkv_bias, has_mask, has_bias)
    primals = [jnp.asarray(o[k], jdt if k in ("x", "wq", "bq") else None) for k in names]
    _, vjp = jax.vjp(fn, *primals)
    want = dict(zip(names, vjp(jnp.asarray(o["dout"], jdt))))
    dx, dwq, dbq, dbias, dls = wa.window_attention_qkv_bwd_plain(
        *_port_args(o, tdt, use_cos, qkv_bias, has_bias), _t(o["dout"]).to(tdt), ws=WS,
        num_heads=H, use_cos=use_cos, sm_scale=SM_SCALE, has_mask=has_mask)
    assert dx.dtype == tdt and dwq.dtype == dbq.dtype == dbias.dtype == torch.float32
    assert (dls is None) == (not use_cos)
    got = dict(x=dx, wq=dwq.to(tdt), bq=dbq.to(tdt), bias=dbias, ls=dls)
    for name in names:
        w = np.asarray(jnp.asarray(want[name]).astype(jnp.float32))
        g = got[name].float().numpy().reshape(w.shape)
        assert np.isfinite(g).all(), name
        if dtype == "float32":
            scale = np.abs(w).max() + 1e-12
            np.testing.assert_allclose(g / scale, w / scale, atol=F32_GRAD, err_msg=name)
        else:
            assert _rel_l2(g, w) <= BF16_GRAD, (name, _rel_l2(g, w))


@pytest.mark.parametrize("use_cos", [True, False])
def test_qkv_function_backward_is_the_plain_backward(use_cos):
    """``window_attention_qkv`` on the CPU: its forward is K16's plain version, and its
    backward (K17's plain version, through the autograd function) equals autograd
    through that plain forward, in float32; the gradients come back in each operand's
    dtype."""
    o = _operands(5)
    args = [t if t is None else t.clone().requires_grad_(t.dtype.is_floating_point)
            for t in _port_args(o, torch.float32, use_cos, True, True)]
    kw = dict(ws=WS, num_heads=H, use_cos=use_cos, sm_scale=SM_SCALE, has_mask=True)
    dout = _t(o["dout"])
    out = wa.window_attention_qkv(*args, **kw)
    leaves = [a for a in args if a is not None and a.requires_grad]
    got = torch.autograd.grad(out, leaves, dout)
    ref = wa.window_attention_qkv_plain(*args, **kw)
    assert torch.equal(out, ref)
    want = torch.autograd.grad(ref, leaves, dout)
    for g, w, a in zip(got, want, leaves):
        assert g.dtype == a.dtype
        scale = float(w.abs().max()) + 1e-12
        np.testing.assert_allclose(g.numpy() / scale, w.numpy() / scale, atol=1e-6)


def test_attention_kernels_take():
    """The operands the window-attention families take, the rule their wrappers refuse
    by on the card, forward and backward alike: bf16 or f32, ws 64, head dim 32, T % 64,
    and C <= 384 for the fused-qkv kernels (K1/K4, K16/K17); f16 is refused."""
    bf, f32 = torch.bfloat16, torch.float32
    for fam in ("window_attention", "window_attention_qkv_epi", "window_attention_qkv"):
        for dt in (bf, f32):
            assert wa.kernels_take(fam, 262144, 96, 3, 64, dt)
            assert wa.kernels_take(fam, 16384, 384, 12, 64, dt)
            assert not wa.kernels_take(fam, 4096, 96, 3, 16, dt)  # window 16
            assert not wa.kernels_take(fam, 4096, 96, 3, 4, dt)  # the default window 4
            assert not wa.kernels_take(fam, 96, 96, 3, 48, dt)  # ws = N, a short stage
            assert not wa.kernels_take(fam, 4096, 32, 2, 64, dt)  # head dim 16
            assert not wa.kernels_take(fam, 4000, 96, 3, 64, dt)  # T % 64
        assert not wa.kernels_take(fam, 262144, 96, 3, 64, torch.float16)
    for dt in (bf, f32):
        assert wa.kernels_take("window_attention", 4096, 768, 24, 64, dt)
        assert not wa.kernels_take("window_attention_qkv", 4096, 768, 24, 64, dt)  # C > 384
        assert not wa.kernels_take("window_attention_qkv_epi", 4096, 768, 24, 64, dt)


def test_final_head_kernels_take():
    """The dtype and shapes the segmentation tail's kernels take, the train pair and K3
    alike: bf16 and f32, every C % 8 == 0 from 8 to 192, F from 1 to 128, T % 64 (on the
    row cores at C 32, 64, 96, 128 where a block's shared memory holds the kernel, heads
    above 32 bf16 / 16 f32 in chunks, on the wide route elsewhere;
    ``tests/test_torch_cuda_kernels.py``)."""
    bf, f32 = torch.bfloat16, torch.float32
    assert fh.kernels_take(262144, 96, 10, bf)
    assert fh.kernels_take(262144, 96, 10, bf, train=False)
    assert fh.kernels_take(262144, 96, 10, f32)
    assert fh.kernels_take(262144, 96, 10, f32, train=False)
    assert fh.kernels_take(262144, 96, 17, f32, train=False)  # the f32 head in chunks
    assert fh.kernels_take(262144, 48, 10, f32, train=False)
    assert fh.kernels_take(262144, 96, 40, bf)  # the bf16 head in chunks
    assert fh.kernels_take(262144, 8, 10, bf)  # C % 16 == 8
    assert not fh.kernels_take(262144, 96, 129, bf)  # F > 128
    assert not fh.kernels_take(262144, 12, 10, bf)  # C % 8
    assert not fh.kernels_take(1000, 96, 10, bf)  # T % 64
    assert fh.kernels_take(128, 128, 10, bf)
    assert fh.kernels_take(128, 128, 10, bf, train=False)
    assert fh.kernels_take(128, 144, 10, bf)  # past the row core's C 128
    assert fh.kernels_take(128, 192, 10, bf, train=False)
    assert not fh.kernels_take(128, 200, 10, bf)  # past C 192
    assert not fh.kernels_take(128, 200, 10, bf, train=False)


def _counters():
    return dict(wa.launches), wa.launches_by_shape.copy()


def test_wrappers_take_the_plain_version_under_auto_on_the_cpu():
    """On CPU tensors "auto" runs the plain versions whatever the kernels take, and
    "pallas" raises."""
    o = _operands(6)
    args = _port_args(o, torch.float32, False, True, True)
    kw = dict(ws=WS, num_heads=H, use_cos=False, sm_scale=SM_SCALE)
    before = _counters()
    plain = wa.window_attention_qkv_plain(*args, **kw)
    for impl in ("auto", "xla"):
        assert torch.equal(wa.window_attention_qkv_fwd(*args, **kw, impl=impl), plain)
    got = wa.window_attention_qkv_bwd(*args, _t(o["dout"]), **kw)
    want = wa.window_attention_qkv_bwd_plain(*args, _t(o["dout"]), **kw)
    assert all((g is None and w is None) or torch.equal(g, w) for g, w in zip(got, want))
    assert _counters() == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        wa.window_attention_qkv_fwd(*args, **kw, impl="pallas")


@pytest.mark.parametrize("dim,heads,cos,route", [
    (32, 2, False, "window_attention_qkv_plain"),
    (32, 2, True, "window_attention_qkv_epi_plain"),
    (416, 13, False, "window_attention_plain"),
])
def test_window_attention_routes(monkeypatch, dim, heads, cos, route):
    """``WindowAttention`` picks its route as the JAX module's Pallas plan does:
    scaled-dot at C <= 384 through ``window_attention_qkv`` (K16/K17) with proj and the
    v2 LayerNorm after it, cosine at C <= 384 through K1/K4, and C > 384 through the
    qkv matmul and K2/K5.  The scaled-dot route equals the dense composition (qkv
    linear, attention, proj, LN) in float32, forward and gradients."""
    calls = []
    for name in ("window_attention_qkv_plain", "window_attention_qkv_epi_plain",
                 "window_attention_plain"):
        fn = getattr(wa, name)
        monkeypatch.setattr(wa, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n),
                                                                          _fn(*a, **k))[1])
    gen = torch.Generator().manual_seed(0)
    mod = WindowAttention(dim, heads, use_cos_attn=cos)
    ln = LayerNorm(dim)
    with torch.no_grad():
        for p in list(mod.parameters()) + list(ln.parameters()):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    x = torch.randn(2, 3, 16, dim, generator=gen, requires_grad=True)
    groups = torch.randint(0, 3, (3, 16), generator=gen, dtype=torch.int32)
    out = mod(x, groups, ln=ln)
    assert calls[0] == route and out.shape == x.shape
    if route != "window_attention_qkv_plain":
        return
    dz = torch.randn(out.shape, generator=gen)
    got = torch.autograd.grad(out, [x] + list(mod.parameters()), dz)
    assert calls == [route, "window_attention_plain"]  # K16's plain version runs K2's
    xf = x.reshape(-1, dim)
    qkv = torch.nn.functional.linear(xf, mod.qkv.weight, mod.qkv.bias)
    ref = ln(torch.nn.functional.linear(
        wa.window_attention_plain(qkv, groups.repeat(2, 1), None, None, ws=16, num_heads=heads,
                                  use_cos=False, sm_scale=(dim // heads) ** -0.5),
        mod.proj.weight, mod.proj.bias)).reshape(x.shape)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    want = torch.autograd.grad(ref, [x] + list(mod.parameters()), dz)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_f32_attention_that_needs_a_gradient_refuses(monkeypatch):
    """Where the kernels would run (``use_kernel`` forced true, as for a CUDA tensor), a
    float32 call that needs a gradient is taken like a bf16 one: the autograd functions,
    the forward and backward wrappers of all three families and ``WindowAttention`` in
    training without attention dropout pass the refusal and reach the launch, where CPU
    operands raise ("must be a CUDA tensor") before any launch.  What the kernels still
    refuse raises naming impl='xla': f16 operands, and f32 at window 16."""
    monkeypatch.setattr(wa, "use_kernel", lambda t, impl: impl != "xla")
    gen = torch.Generator().manual_seed(3)
    Tk, Ck, h = 128, 64, 2
    x = torch.randn(Tk, Ck, generator=gen, requires_grad=True)
    wq, bq = torch.randn(Ck, 3 * Ck, generator=gen) * 0.1, torch.zeros(3 * Ck)
    wp, bp = torch.randn(Ck, Ck, generator=gen) * 0.1, torch.zeros(Ck)
    g, b = torch.ones(Ck), torch.zeros(Ck)
    ls = torch.full((h,), 10.0)
    qkv = torch.randn(Tk, 3 * Ck, generator=gen, requires_grad=True)
    epi = (x, wq, bq, wp, bp, g, b, None, None, ls)
    kw = dict(ws=64, num_heads=h, sm_scale=0.2, has_mask=False)
    akw = dict(kw, use_cos=True)
    before = dict(wa.launches)
    cuda = "must be a CUDA tensor"
    refused = r"bfloat16 or float32 operands.*impl='xla'"
    for impl in ("auto", "pallas"):
        for dkw in (akw, dict(kw, use_cos=False)):
            with pytest.raises(ValueError, match=cuda):
                wa.window_attention_qkv(x, wq, bq, None, None, ls, **dkw, impl=impl)
            with pytest.raises(ValueError, match=cuda):
                wa.window_attention_qkv_bwd(x, wq, bq, None, None, ls, x.detach(), **dkw,
                                            impl=impl)
            with pytest.raises(ValueError, match=cuda):
                wa.window_attention(qkv, None, None, ls, **dkw, impl=impl)
            with pytest.raises(ValueError, match=cuda):
                wa.window_attention_bwd(qkv.detach(), None, None, ls, x.detach(), **dkw,
                                        impl=impl)
        with pytest.raises(ValueError, match=cuda):
            wa.window_attention_qkv_epi(*epi, **kw, impl=impl)
        with pytest.raises(ValueError, match=cuda):
            wa.window_attention_qkv_epi_fwd(*epi, **kw, impl=impl)
        with pytest.raises(ValueError, match=cuda):
            wa.window_attention_qkv_epi_bwd(*epi, x.detach(), **kw, impl=impl)
        with pytest.raises(ValueError, match=cuda):
            wa.qkv_epi_proj_ln_bwd(x.detach(), wp, bp, g, x.detach(), impl=impl)
        with pytest.raises(ValueError, match=cuda):
            wa.gemm_nt(qkv.detach(), wq, impl=impl)
        with pytest.raises(ValueError, match=refused):
            wa.window_attention_qkv_epi(*(a.half() if isinstance(a, torch.Tensor) and
                                          a.dtype == torch.float32 and a.ndim == 2 else a
                                          for a in epi), **kw, impl=impl)
        with pytest.raises(ValueError, match=refused):
            wa.window_attention(qkv.half(), None, None, ls, **akw, impl=impl)
        with pytest.raises(ValueError, match=r"ws=64.*impl='xla'"):
            wa.window_attention_qkv(x, wq, bq, None, None, ls, **dict(akw, ws=16), impl=impl)
    mod = WindowAttention(Ck, h, use_cos_attn=True).train()
    with pytest.raises(ValueError, match=cuda):
        mod(x.detach().reshape(2, 1, 64, Ck), None, ln=LayerNorm(Ck), generator=gen)
    assert dict(wa.launches) == before
    for fam in ("window_attention", "window_attention_qkv_epi", "window_attention_qkv"):
        assert wa.kernels_take(fam, Tk, Ck, h, 64, torch.float32)
        assert not wa.kernels_take(fam, Tk, Ck, h, 64, torch.float16)

