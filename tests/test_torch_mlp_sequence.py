"""K13's launch sequence, step by step, against the JAX package on the CPU.

On the card K13 (``mlp_bwd``) launches a dx kernel and then a weight-gradient kernel.
Their plain versions, ``mlp_bwd_dx_plain`` and ``mlp_bwd_dw_plain``, are held here to
the Pallas backward of ``heal_swin_tpu/ops/mlp.py`` run in interpret mode
(``fused_mlp(..., interpret=True)`` under ``jax.vjp``), on the same numpy inputs, in
float32 and bfloat16, both GELUs, and at an H that is not a multiple of 64:

- float32: gradients within 2e-4 (rtol and atol), the JAX tests' own tolerance: the same
  f32 math in another order.
- bfloat16: relative L2 <= 2e-3.  The Pallas VJP returns dW1 and dW2 in the weights'
  dtype, so the plain f32 sums are rounded to bf16 before the comparison, as the port's
  autograd function returns them.

``mlp_bwd_plain`` is the two steps composed: ``torch.equal`` to them.
"""

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


def _operands(T, C, H, seed):
    """x (T, C), w1 (C, H), b1 (H,), w2 (H, C), b2 (C,), dout (T, C), f32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return [rng.normal(size=(T, C)).astype(f), (rng.normal(size=(C, H)) * 0.1).astype(f),
            (rng.normal(size=H) * 0.1).astype(f), (rng.normal(size=(H, C)) * 0.1).astype(f),
            (rng.normal(size=C) * 0.1).astype(f), rng.normal(size=(T, C)).astype(f)]


def _both(ops, dtype):
    """The JAX and torch operands: x, w1, w2 and dout in ``dtype``, the biases f32."""
    jdt, tdt = DTYPES[dtype]
    low = (0, 1, 3, 5)
    j = [jnp.asarray(a, jdt if i in low else jnp.float32) for i, a in enumerate(ops)]
    t = [torch.from_numpy(a).to(tdt if i in low else torch.float32) for i, a in enumerate(ops)]
    return j, t


def _pallas_grads(j, approximate):
    """dx, dW1, db1, dW2, db2 of the Pallas backward in interpret mode, through jax.vjp
    of ``fused_mlp`` for the output gradient dout."""
    x, w1, b1, w2, b2, dout = j
    _, vjp = jax.vjp(lambda *a: jm.fused_mlp(*a, approximate=approximate, interpret=True),
                     x, w1, b1, w2, b2)
    return vjp(dout)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("T,C,H", SHAPES)
def test_mlp_bwd_dx_plain_matches_pallas(T, C, H, approximate, dtype):
    """The dx kernel's plain version against dx of the Pallas backward."""
    j, t = _both(_operands(T, C, H, seed=C + H), dtype)
    want = _pallas_grads(j, approximate)[0]
    x, w1, b1, w2, _, dout = t
    got = tm.mlp_bwd_dx_plain(x, w1, b1, w2, dout, approximate=approximate)
    assert got.dtype == x.dtype and got.shape == x.shape
    _assert_close(got, want, dtype, "dx")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("T,C,H", SHAPES)
def test_mlp_bwd_dw_plain_matches_pallas(T, C, H, approximate, dtype):
    """The weight-gradient kernel's plain version against the Pallas backward's dW1,
    db1, dW2 and db2 (f32 sums; dW1 and dW2 rounded to the weights' dtype, as the
    Pallas VJP returns them)."""
    j, t = _both(_operands(T, C, H, seed=C + H + 1), dtype)
    _, dw1, db1, dw2, db2 = _pallas_grads(j, approximate)
    x, w1, b1, w2, _, dout = t
    got = tm.mlp_bwd_dw_plain(x, w1, b1, w2, dout, approximate=approximate)
    assert [tuple(g.shape) for g in got] == [(C, H), (H,), (H, C), (C,)]
    assert all(g.dtype == torch.float32 for g in got)
    gw1, gb1, gw2, gb2 = got
    for name, g, w in (("dW1", gw1.to(x.dtype), dw1), ("db1", gb1, db1),
                       ("dW2", gw2.to(x.dtype), dw2), ("db2", gb2, db2)):
        _assert_close(g, w, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("approximate", [True, False])
def test_mlp_bwd_plain_is_the_two_steps_composed(approximate, dtype):
    """``mlp_bwd_plain`` returns the dx step's and the weight-gradient step's results,
    bit for bit."""
    _, t = _both(_operands(128, 32, 96, seed=5), dtype)
    x, w1, b1, w2, b2, dout = t
    whole = tm.mlp_bwd_plain(x, w1, b1, w2, b2, dout, approximate=approximate)
    steps = (tm.mlp_bwd_dx_plain(x, w1, b1, w2, dout, approximate=approximate),
             *tm.mlp_bwd_dw_plain(x, w1, b1, w2, dout, approximate=approximate))
    assert len(whole) == len(steps) == 5
    assert all(torch.equal(a, b) for a, b in zip(whole, steps))


@pytest.mark.parametrize("H", [96, 160])
def test_mlp_step_wrappers_run_the_plain_versions_on_the_cpu(H):
    """On CPU tensors the step wrappers (``mlp_bwd_dx``, ``mlp_bwd_dw``) are their plain
    versions, and ``supported`` takes an H that is a multiple of 32 but not of 64."""
    _, t = _both(_operands(64, 32, H, seed=H), "bfloat16")
    x, w1, b1, w2, _, dout = t
    assert tm.supported(64, 32, H)
    assert torch.equal(tm.mlp_bwd_dx(x, w1, b1, w2, dout, approximate=True),
                       tm.mlp_bwd_dx_plain(x, w1, b1, w2, dout, approximate=True))
    got = tm.mlp_bwd_dw(x, w1, b1, w2, dout, approximate=False)
    want = tm.mlp_bwd_dw_plain(x, w1, b1, w2, dout, approximate=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
