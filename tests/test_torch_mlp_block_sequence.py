"""K15's launch sequence, step by step, against the JAX package on the CPU.

On the card K15 (``mlp_block_bwd``) launches the row kernel with the LayerNorm backward
epilogue (du, rounded, and the db2, dgamma, dbeta sums), then K13's dx kernel on du with
the residual dz, then K13's weight-gradient kernel on du.  Their plain versions,
``mlp_block_du_plain``, ``mlp_bwd_dx_plain(..., residual=dz)`` and ``mlp_bwd_dw_plain``,
are held here to the Pallas backward of ``heal_swin_tpu/ops/mlp.py``'s MLP branch run in
interpret mode (``fused_mlp_block(..., interpret=True)`` under ``jax.vjp``), on the same
numpy inputs, in float32 and bfloat16, both GELUs, with and without the DropPath scale,
and at an H that is not a multiple of 64:

- float32: gradients within 2e-4 (rtol and atol), the JAX tests' own tolerance: the same
  f32 math in another order.
- bfloat16: relative L2 <= 2e-3.  The Pallas VJP returns dW1 and dW2 in the weights'
  dtype, so the plain f32 sums are rounded to bf16 before the comparison, as the port's
  autograd function returns them.

``mlp_block_bwd_plain`` is the three steps composed: ``torch.equal`` to them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch.ops import mlp as tm
from heal_swin_tpu.ops import mlp as jm

F32_GRAD_TOL = 2e-4
BF16_REL_L2 = 2e-3
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(128, 32, 96), (128, 32, 128), (64, 96, 384)]  # (T, C, H)
LOW = (0, 1, 3, 8)  # x, w1, w2 and dz take the dtype under test; the rest stay f32


def _operands(T, C, H, seed):
    """x, w1, b1, w2, b2, gamma, beta, dscale (T, 1), dz: f32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return [rng.normal(size=(T, C)).astype(f), (rng.normal(size=(C, H)) * 0.1).astype(f),
            (rng.normal(size=H) * 0.1).astype(f), (rng.normal(size=(H, C)) * 0.1).astype(f),
            (rng.normal(size=C) * 0.1).astype(f), (1.0 + 0.3 * rng.normal(size=C)).astype(f),
            (0.2 * rng.normal(size=C)).astype(f),
            rng.choice([0.0, 1.25], size=(T, 1)).astype(f), rng.normal(size=(T, C)).astype(f)]


def _both(ops, dtype, has_dp):
    """The JAX and torch operands (dscale None without the DropPath scale)."""
    jdt, tdt = DTYPES[dtype]
    j = [jnp.asarray(a, jdt if i in LOW else jnp.float32) for i, a in enumerate(ops)]
    t = [torch.from_numpy(a).to(tdt if i in LOW else torch.float32) for i, a in enumerate(ops)]
    if not has_dp:
        j[7] = t[7] = None
    return j, t


@functools.lru_cache(maxsize=None)
def _pallas_grads(T, C, H, approximate, dtype, has_dp, seed):
    """dx, dW1, db1, dW2, db2, dgamma, dbeta of the Pallas branch backward in interpret
    mode, through jax.vjp of ``fused_mlp_block`` for the output gradient dz."""
    j, _ = _both(_operands(T, C, H, seed), dtype, has_dp)
    *params, ds, dz = j
    _, vjp = jax.vjp(lambda *a: jm.fused_mlp_block(*a, ds, approximate=approximate,
                                                   rblks=(32, 16), interpret=True), *params)
    return vjp(dz)


def _case(T, C, H, approximate, dtype, has_dp):
    seed = T + C + H + 2 * approximate + has_dp
    _, t = _both(_operands(T, C, H, seed), dtype, has_dp)
    return t, _pallas_grads(T, C, H, approximate, dtype, has_dp, seed)


def _assert_close(got, want, dtype, name):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy().reshape(want.shape)
    assert np.isfinite(got).all(), name
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_GRAD_TOL, atol=F32_GRAD_TOL,
                                   err_msg=name)
    else:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= BF16_REL_L2, (name, err)


CASES = [pytest.param(T, C, H, approximate, dtype, has_dp,
                      id=f"{T}x{C}x{H}-{'tanh' if approximate else 'erf'}-{dtype}"
                         f"{'-dscale' if has_dp else ''}")
         for T, C, H in SHAPES for approximate in (True, False)
         for dtype in ("float32", "bfloat16") for has_dp in (False, True)]


@pytest.mark.parametrize("T,C,H,approximate,dtype,has_dp", CASES)
def test_mlp_block_du_plain_matches_pallas(T, C, H, approximate, dtype, has_dp):
    """The first step's plain version: du in x's dtype, and its db2, dgamma and dbeta
    against the Pallas backward's."""
    t, (_, _, _, _, db2, dgamma, dbeta) = _case(T, C, H, approximate, dtype, has_dp)
    x, w1, b1, w2, b2, gamma, _, ds, dz = t
    du, *sums = tm.mlp_block_du_plain(x, w1, b1, w2, b2, gamma, ds, dz,
                                      approximate=approximate)
    assert du.dtype == x.dtype and du.shape == x.shape
    assert all(s.dtype == torch.float32 and s.shape == (C,) for s in sums)
    for name, g, w in zip(("db2", "dgamma", "dbeta"), sums, (db2, dgamma, dbeta)):
        _assert_close(g, w, dtype, name)


@pytest.mark.parametrize("T,C,H,approximate,dtype,has_dp", CASES)
def test_mlp_bwd_dx_plain_with_residual_matches_pallas(T, C, H, approximate, dtype, has_dp):
    """The dx step's plain version on the first step's du with the residual dz against
    the Pallas backward's dx."""
    t, want = _case(T, C, H, approximate, dtype, has_dp)
    x, w1, b1, w2, b2, gamma, _, ds, dz = t
    du = tm.mlp_block_du_plain(x, w1, b1, w2, b2, gamma, ds, dz, approximate=approximate)[0]
    dx = tm.mlp_bwd_dx_plain(x, w1, b1, w2, du, approximate=approximate, residual=dz)
    assert dx.dtype == x.dtype and dx.shape == x.shape
    _assert_close(dx, want[0], dtype, "dx")


@pytest.mark.parametrize("T,C,H,approximate,dtype,has_dp", CASES)
def test_mlp_bwd_dw_plain_on_du_matches_pallas(T, C, H, approximate, dtype, has_dp):
    """The weight-gradient step's plain version on the first step's du against the
    Pallas backward's dW1, db1 and dW2 (dW1 and dW2 rounded to the weights' dtype, as
    the Pallas VJP returns them)."""
    t, (_, dw1, db1, dw2, _, _, _) = _case(T, C, H, approximate, dtype, has_dp)
    x, w1, b1, w2, b2, gamma, _, ds, dz = t
    du = tm.mlp_block_du_plain(x, w1, b1, w2, b2, gamma, ds, dz, approximate=approximate)[0]
    gw1, gb1, gw2, _ = tm.mlp_bwd_dw_plain(x, w1, b1, w2, du, approximate=approximate)
    for name, g, w in (("dW1", gw1.to(x.dtype), dw1), ("db1", gb1, db1),
                       ("dW2", gw2.to(x.dtype), dw2)):
        _assert_close(g, w, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("has_dp", [False, True])
def test_mlp_block_bwd_plain_is_the_three_steps_composed(has_dp, approximate, dtype):
    """``mlp_block_bwd_plain`` returns the steps' results bit for bit: dx of the dx step
    with the residual, dW1, db1 and dW2 of the weight-gradient step, and db2, dgamma and
    dbeta of the first step."""
    _, t = _both(_operands(128, 32, 96, seed=9), dtype, has_dp)
    x, w1, b1, w2, b2, gamma, beta, ds, dz = t
    kw = dict(approximate=approximate)
    whole = tm.mlp_block_bwd_plain(x, w1, b1, w2, b2, gamma, beta, ds, dz, **kw)
    du, db2, dgamma, dbeta = tm.mlp_block_du_plain(x, w1, b1, w2, b2, gamma, ds, dz, **kw)
    dw1, db1, dw2, _ = tm.mlp_bwd_dw_plain(x, w1, b1, w2, du, **kw)
    steps = (tm.mlp_bwd_dx_plain(x, w1, b1, w2, du, residual=dz, **kw), dw1, db1, dw2, db2,
             dgamma, dbeta)
    assert len(whole) == len(steps) == 7
    assert all(torch.equal(a, b) for a, b in zip(whole, steps))


@pytest.mark.parametrize("has_dp", [False, True])
def test_mlp_block_step_wrappers_run_the_plain_versions_on_the_cpu(has_dp):
    """On CPU tensors the step wrappers (``mlp_block_bwd_du``, ``mlp_bwd_dx`` with a
    residual) are their plain versions; without a residual ``mlp_bwd_dx_plain`` is K13's
    dx step as before."""
    _, t = _both(_operands(64, 32, 160, seed=11), "bfloat16", has_dp)
    x, w1, b1, w2, b2, gamma, _, ds, dz = t
    kw = dict(approximate=True)
    got = tm.mlp_block_bwd_du(x, w1, b1, w2, b2, gamma, ds, dz, **kw)
    want = tm.mlp_block_du_plain(x, w1, b1, w2, b2, gamma, ds, dz, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    du = want[0]
    assert torch.equal(tm.mlp_bwd_dx(x, w1, b1, w2, du, residual=dz, **kw),
                       tm.mlp_bwd_dx_plain(x, w1, b1, w2, du, residual=dz, **kw))
    plain = tm.mlp_bwd_dx_plain(x, w1, b1, w2, du, **kw)
    residual = tm.mlp_bwd_dx_plain(x, w1, b1, w2, du, residual=torch.zeros_like(dz), **kw)
    assert torch.equal(plain, residual)
