"""The MLP kernels' plain versions (K12-K15) and the port's ``Mlp`` against the JAX
package on the CPU.

The JAX side runs the Pallas kernels of ``heal_swin_tpu/ops/mlp.py`` in interpret
mode, as ``tests/test_mlp_kernel.py`` does: ``fused_mlp(..., interpret=True,
fwd_impl="pallas")`` (rows 14-15), ``fused_mlp_block(..., interpret=True)`` (rows
16-17) and their ``jax.grad``s, on the same numpy inputs:

- float32: outputs within 1e-5 and gradients within 2e-4 (normalized by the largest
  entry for the branch's), the JAX tests' own tolerances: the same f32 math in
  another order.
- bfloat16: relative L2 <= 2e-3 for the output and every gradient.  Both sides round
  at the same points (g, the output, dh before dx and dW1, du before dW2 and the
  hidden's gradient) and differ only where f32 sums in another order flip a rounding.

The port's ``Mlp(mlp_impl="fused")`` is held to the JAX module the same way, except
its bf16 forward, which is neither kernel but each framework's plain dense route
(relative L2 1e-2; see the test).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch import convert
from heal_swin_torch.models import layers as tl
from heal_swin_torch.models import swin_hp as tsh
from heal_swin_torch.ops import mlp as tm
from heal_swin_tpu.models import layers as jl
from heal_swin_tpu.ops import mlp as jm

F32_TOL = 1e-5
F32_GRAD_TOL = 2e-4
BF16_REL_L2 = 2e-3
MODULE_BF16_FWD_REL_L2 = 1e-2  # test_mlp_module_fused_matches_jax's bf16 forward
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _operands(T, C, H, seed):
    """x (T, C), w1 (C, H), b1 (H,), w2 (H, C), b2 (C,), gamma, beta (C,), f32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(x=rng.normal(size=(T, C)).astype(f),
                w1=(rng.normal(size=(C, H)) * 0.1).astype(f),
                b1=(rng.normal(size=H) * 0.1).astype(f),
                w2=(rng.normal(size=(H, C)) * 0.1).astype(f),
                b2=(rng.normal(size=C) * 0.1).astype(f),
                gam=(1.0 + 0.3 * rng.normal(size=C)).astype(f),
                bet=(0.2 * rng.normal(size=C)).astype(f),
                ds=rng.choice([0.0, 1.25], size=(T, 1)).astype(f))


def _inputs(ops, names, dtype):
    """The JAX and torch inputs: x, w1, w2 in ``dtype``, the rest f32 (as the JAX tests
    hand them to the kernels)."""
    jdt, tdt = DTYPES[dtype]
    low = {"x", "w1", "w2"}
    j = [jnp.asarray(ops[n], jdt if n in low else jnp.float32) for n in names]
    t = [torch.from_numpy(ops[n]).to(tdt if n in low else torch.float32).requires_grad_()
         for n in names]
    return j, t


def _assert_close(got, want, dtype, name, tol=F32_TOL, normalize=False,
                  bf16_tol=BF16_REL_L2):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy().reshape(want.shape)
    assert np.isfinite(got).all(), name
    if dtype == "float32":
        scale = np.abs(want).max() + 1e-12 if normalize else 1.0
        np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol, err_msg=name)
    else:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= bf16_tol, (name, err)


def _sin_loss(o):
    return jnp.sum(jnp.sin(o.astype(jnp.float32)))


MLP = ["x", "w1", "b1", "w2", "b2"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("C", [32, 96])
def test_mlp_forward_matches_pallas(C, approximate, dtype):
    """K12's plain version (``fused_mlp`` with fwd_impl "pallas" on a CPU tensor) vs
    the Pallas forward kernel in interpret mode."""
    ops = _operands(128, C, 4 * C, seed=C)
    j, t = _inputs(ops, MLP, dtype)
    want = jm.fused_mlp(*j, approximate=approximate, rblk=32, interpret=True,
                        fwd_impl="pallas")
    got = tm.fused_mlp(*t, approximate=approximate, fwd_impl="pallas")
    assert got.dtype == DTYPES[dtype][1]
    _assert_close(got, want, dtype, "out")
    _assert_close(tm.mlp_plain(*t, approximate=approximate), want, dtype, "mlp_plain")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fwd_impl", ["xla", "pallas"])
@pytest.mark.parametrize("approximate", [True, False])
def test_mlp_grads_match_pallas(approximate, fwd_impl, dtype):
    """K13's plain version through ``fused_mlp``'s autograd function vs ``jax.grad`` of
    the Pallas backward kernel in interpret mode: dx and every parameter gradient."""
    ops = _operands(128, 32, 128, seed=3)
    j, t = _inputs(ops, MLP, dtype)
    gj = jax.grad(lambda *a: _sin_loss(jm.fused_mlp(
        *a, approximate=approximate, rblk=16, interpret=True, fwd_impl=fwd_impl)),
        argnums=tuple(range(5)))(*j)
    out = tm.fused_mlp(*t, approximate=approximate, fwd_impl=fwd_impl)
    torch.sin(out.float()).sum().backward()
    for name, a, want in zip(MLP, t, gj):
        assert a.grad.dtype == a.dtype, name
        _assert_close(a.grad, want, dtype, f"d{name}", tol=F32_GRAD_TOL)


def test_mlp_bwd_plain_matches_the_pallas_kernel_call():
    """``mlp_bwd_plain`` against the Pallas backward kernel called directly: the f32
    parameter sums before any cast, for an arbitrary output gradient."""
    ops = _operands(128, 96, 384, seed=4)
    dout = np.random.default_rng(5).normal(size=(128, 96)).astype(np.float32)
    j, t = _inputs(ops, MLP, "float32")
    bwd = jm._make_pallas_bwd(96, 384, True, 32, "float32", True)
    want = bwd(*j, jnp.asarray(dout))
    got = tm.mlp_bwd_plain(*t, torch.from_numpy(dout), approximate=True)
    for name, g, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        _assert_close(g, w, "float32", name, tol=F32_GRAD_TOL)


BLOCK = ["x", "w1", "b1", "w2", "b2", "gam", "bet"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("has_dp", [False, True])
@pytest.mark.parametrize("approximate", [True, False])
def test_mlp_block_matches_pallas(approximate, has_dp, dtype):
    """K14/K15's plain versions through ``fused_mlp_block`` vs the Pallas branch
    kernels in interpret mode: the output and every gradient (dscale's is 0)."""
    ops = _operands(128, 32, 128, seed=7)
    j, t = _inputs(ops, BLOCK, dtype)
    ds_j = jnp.asarray(ops["ds"]) if has_dp else None
    ds_t = torch.from_numpy(ops["ds"]).requires_grad_() if has_dp else None

    def fused(*a):
        return jm.fused_mlp_block(*a, ds_j, approximate=approximate, rblks=(32, 16),
                                  interpret=True)

    want = fused(*j)
    got = tm.fused_mlp_block(*t, ds_t, approximate=approximate)
    _assert_close(got, want, dtype, "out", tol=2e-5)
    gj = jax.grad(lambda *a: _sin_loss(fused(*a)), argnums=tuple(range(7)))(*j)
    torch.sin(got.float()).sum().backward()
    for name, a, w in zip(BLOCK, t, gj):
        _assert_close(a.grad, w, dtype, f"d{name}", tol=5e-6, normalize=True)
    if has_dp:
        assert torch.equal(ds_t.grad, torch.zeros_like(ds_t))
    # the plain versions alone, against the jnp oracle of the branch
    ref = jm.reference_mlp_block(*j, ds_j, approximate=approximate)
    _assert_close(tm.mlp_block_plain(*t, ds_t, approximate=approximate), ref, dtype, "plain")


def _jax_mlp_fused(monkeypatch):
    """The JAX ``Mlp`` with its fused gate forced open and the kernel interpreted, as
    ``test_mlp_kernel.py`` runs it on the CPU."""
    monkeypatch.setattr(jm, "supported", lambda *a, **k: True)
    monkeypatch.setattr(jm, "fused_mlp_nd",
                        functools.partial(jm.fused_mlp_nd, rblk=16, interpret=True))


_ORIG_FUSED_MLP_ND = tm.fused_mlp_nd


def _spy(calls, *a, **k):
    """``fused_mlp_nd`` that records its calls in ``calls``."""
    calls.append(1)
    return _ORIG_FUSED_MLP_ND(*a, **k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("approximate", [True, False])
def test_mlp_module_fused_matches_jax(approximate, dtype, monkeypatch):
    """The port's ``Mlp(mlp_impl="fused")`` (plain forward, K13's plain version
    backward) against the JAX ``Mlp(mlp_impl="fused")`` on weights carried through
    ``convert``: the output and every parameter gradient, and the same against the
    JAX module's plain path in f32."""
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(1).normal(size=(2, 8, 16, 96)).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    jmods = {impl: jl.Mlp(hidden_features=384, out_features=96, gelu_approx=approximate,
                          mlp_impl=impl) for impl in ("xla", "fused")}
    params = jmods["xla"].init(jax.random.PRNGKey(0), xj, True)
    rng = np.random.default_rng(2)  # LN-free module: noise the zero biases
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape)
                          .astype(np.float32), params)
    _jax_mlp_fused(monkeypatch)

    def loss(impl, p):
        return _sin_loss(jmods[impl].apply(p, xj, True))

    out_j = jmods["fused"].apply(params, xj, True)
    grads_j = convert._flatten(jax.grad(functools.partial(loss, "fused"))(params)["params"])

    mod = tl.Mlp(96, 384, 96, gelu_approx=approximate, mlp_impl="fused")
    sd = dict(convert._torch_key(p, v, 4) for p, v in
              convert._flatten(params["params"]).items())
    mod.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                        strict=True)
    calls = []
    with monkeypatch.context() as m:
        m.setattr(tm, "fused_mlp_nd", functools.partial(_spy, calls))
        out_t = mod(torch.from_numpy(x).to(tdt))
    assert calls, "the fused route was not taken"
    # in bf16 the forward is each framework's plain dense route: XLA rounds every op
    # of its bf16 GELU, ATen computes GELU in f32 and rounds once (measured 5.5e-3)
    _assert_close(out_t, out_j, dtype, "out", bf16_tol=MODULE_BF16_FWD_REL_L2)
    torch.sin(out_t.float()).sum().backward()
    grads_t = dict(mod.named_parameters())
    for path, want in grads_j.items():
        key, want_t = convert._torch_key(path, np.asarray(want, np.float32), 4)
        got = grads_t[key].grad
        assert got.dtype == torch.float32, key
        _assert_close(got, want_t, dtype, key, tol=F32_GRAD_TOL)
    if dtype == "float32":  # the JAX plain path agrees too
        _assert_close(out_t, jmods["xla"].apply(params, xj, True), dtype, "vs plain")


def test_mlp_gate_takes_the_plain_route(monkeypatch):
    """``mlp_impl="fused"`` takes ``fused_mlp_nd`` only where the JAX gate would:
    dropout inactive, out_features == C, and a shape the kernel takes.  Dropout active
    (training, drop > 0) sends it to the plain route, as it does the JAX module; there
    without a generator it raises before any route."""
    calls = []
    monkeypatch.setattr(tm, "fused_mlp_nd", functools.partial(_spy, calls))
    x = torch.randn(2, 64, 32)

    def routed(mod, inp=x, generator=None):
        calls.clear()
        mod(inp, generator)
        return bool(calls)

    assert routed(tl.Mlp(32, 128, 32, mlp_impl="fused"))
    assert not routed(tl.Mlp(32, 128, 32))  # mlp_impl "xla"
    assert not routed(tl.Mlp(32, 128, 64, mlp_impl="fused"))  # out_features != C
    assert not routed(tl.Mlp(32, 128, 32, mlp_impl="fused"), torch.randn(2, 7, 32))  # T
    assert not routed(tl.Mlp(48, 192, 48, mlp_impl="fused"), torch.randn(2, 64, 48))  # C
    assert routed(tl.Mlp(32, 128, 32, drop=0.1, mlp_impl="fused").eval())  # inactive
    assert not routed(tl.Mlp(32, 128, 32, drop=0.1, mlp_impl="fused").train(),
                      generator=torch.Generator().manual_seed(0))  # active: plain
    with pytest.raises(ValueError, match="Dropout in training needs"):
        routed(tl.Mlp(32, 128, 32, drop=0.1, mlp_impl="fused").train())
    assert not calls
    with pytest.raises(ValueError, match="mlp_impl"):
        tl.Mlp(32, 128, 32, mlp_impl="pallas")


def test_mlp_gate_refuses_a_dtype_the_kernel_does_not_take_at_the_call(monkeypatch):
    """Where K13 would run (a CUDA tensor: ``use_kernel`` forced true here), the fused
    gate's forward raises for a float16 input, before any backward, naming what K13
    takes ("bfloat16 or float32"); float32 and bfloat16 inputs of the same shape pass
    the forward (K13 has both forms), and a shape the gate refuses takes the plain
    route as before."""
    monkeypatch.setattr(tm, "use_kernel", lambda t, impl: impl != "xla")
    mod = tl.Mlp(32, 128, 32, mlp_impl="fused")
    for dt in (torch.float32, torch.bfloat16):
        out = mod.to(dt)(torch.randn(2, 64, 32, dtype=dt))
        assert out.shape == (2, 64, 32) and out.dtype == dt
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        mod.half()(torch.randn(2, 64, 32, dtype=torch.float16))
    mod.half()(torch.randn(2, 7, 32, dtype=torch.float16))  # T 14: the plain route
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tm.fused_mlp(torch.randn(64, 32, dtype=torch.float16), torch.randn(32, 128),
                     torch.zeros(128), torch.randn(128, 32), torch.zeros(32), approximate=True)


def test_element_dropout_in_training_raises():
    """``Mlp`` and ``WindowAttention``'s proj dropout, usable on their own, raise in
    training with a rate above 0 and no generator instead of drawing from the global
    RNG; at eval (or at rate 0) they run, and the global RNG is left as it was."""
    x = torch.randn(2, 4, 16, 32)
    mlp = tl.Mlp(32, 128, 32, drop=0.1)
    attn = tl.WindowAttention(32, 2, proj_drop=0.1, use_cos_attn=True)
    for mod in (mlp, attn):
        with pytest.raises(ValueError, match="Dropout in training needs"):
            mod.train()(x)
        state = torch.get_rng_state()
        a, b = mod.eval()(x), mod(x)
        assert torch.equal(a, b) and torch.equal(torch.get_rng_state(), state)
    tl.Mlp(32, 128, 32).train()(x)
    tl.WindowAttention(32, 2, use_cos_attn=True).train()(x)


def test_gates():
    """Both gates take what the kernels take: T a multiple of 64, C a multiple of 32
    up to 768 (of 64 above 384), H a multiple of 32; no TPU cut-offs."""
    for T, C in ((262144, 96), (65536, 192), (16384, 384), (4096, 768), (128, 32)):
        assert tm.supported(T, C, 4 * C) and tm.block_supported(T, C, 4 * C)
    for T, C, H in ((100, 96, 384), (128, 48, 192), (128, 416, 1664), (128, 832, 3328),
                    (128, 96, 200), (0, 96, 384)):
        assert not tm.supported(T, C, H) and not tm.block_supported(T, C, H)


def test_wrappers_demand_the_kernel_with_pallas():
    """impl="pallas" needs CUDA tensors; "auto" on a CPU tensor runs the plain
    version and counts no launch."""
    ops = _operands(64, 32, 128, seed=9)
    _, t = _inputs(ops, BLOCK, "float32")
    dz = torch.ones(64, 32)
    before = dict(tm.launches)
    for fn, args in ((tm.mlp_fwd, t[:5]), (tm.mlp_bwd, t[:5] + [dz]),
                     (tm.mlp_block_fwd, t + [None]), (tm.mlp_block_bwd, t + [None, dz])):
        with pytest.raises(ValueError, match="pallas"):
            fn(*args, approximate=True, impl="pallas")
        fn(*args, approximate=True)
    assert tm.launches == before
    with pytest.raises(ValueError, match="fwd_impl"):
        tm.fused_mlp(*t[:5], approximate=True, fwd_impl="mosaic")


def test_block_branch_through_fused_mlp_block():
    """A v2 ``SwinHPBlock``'s MLP branch, x + drop_path(norm2(mlp(x))) in training
    with its DropPath draw, equals ``fused_mlp_block`` on the block's own fc1, fc2 and
    norm2 with that draw as dscale (f32, CPU): output and gradients.  This is the
    wiring the card check uses on the paper model's blocks."""
    cfg = tsh.SwinHPTransformerConfig(embed_dim=32, depths=[2], num_heads=[1], window_size=16,
                                      shift_size=8, use_v2_norm_placement=True,
                                      gelu_approx=True, drop_path_rate=0.5)
    blk = tsh.SwinHPBlock(cfg, dim=32, input_resolution=128, base_pix=8, num_heads=1,
                          shift_size=0, drop_path=0.5).train()
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(3)))
    B, N, C = 4, 128, 32
    x = torch.randn(B, N, C, generator=torch.Generator().manual_seed(4))
    state = torch.Generator().manual_seed(11).get_state()

    def gen():
        return torch.Generator().set_state(state)

    xa = x.clone().requires_grad_()
    want = xa + blk.drop_path(blk.norm2(blk.mlp(xa)), gen())
    dscale = blk.drop_path(torch.ones(B, 1, 1), gen()).expand(B, N, 1).reshape(B * N, 1)
    assert set(dscale.unique().tolist()) == {0.0, 2.0}  # both kept and dropped samples
    xb = x.clone().requires_grad_()
    got = tm.fused_mlp_block(
        xb.reshape(B * N, C), blk.mlp.fc1.weight.t(), blk.mlp.fc1.bias, blk.mlp.fc2.weight.t(),
        blk.mlp.fc2.bias, blk.norm2.weight, blk.norm2.bias, dscale.contiguous(),
        approximate=True).reshape(B, N, C)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-5)
    dy = torch.randn(B, N, C, generator=torch.Generator().manual_seed(5))
    params = [blk.mlp.fc1.weight, blk.mlp.fc1.bias, blk.mlp.fc2.weight, blk.mlp.fc2.bias,
              blk.norm2.weight, blk.norm2.bias]
    gw = torch.autograd.grad(want, [xa] + params, dy)
    gg = torch.autograd.grad(got, [xb] + params, dy)
    for a, b in zip(gg, gw):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)
