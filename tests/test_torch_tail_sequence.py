"""K6's partial rows and K7's launch sequence, step by step, against the JAX package on
the CPU.

On the card K6 (``final_head_loss_sums``) and K7's row kernel run on persistent blocks:
block b walks the 128-row tiles b, b + grid, ... and writes one partial row.  K7
(``final_head_loss_bwd``) launches its row kernel (dx, the rounded dh of every
sub-pixel, partial rows [dWh | dgamma | dbeta]), then dWe = x^T dh (``gemm_tn``), then
the reduction of the partial rows.  Their plain twins, ``final_head_loss_partials_plain``,
``final_head_loss_bwd_rows_plain``, ``final_head_loss_dwe_plain`` and
``reduce_rows_plain``, are held here to the Pallas kernels of
``heal_swin_tpu/ops/final_head.py`` run in interpret mode (``fused_final_head(...,
interpret=True)`` and its custom VJP under ``jax.vjp``), on the same numpy inputs, at C 32
and 96, p 4, F 10, T 320 (two full tiles and a half one), on grids of 1, 2 (which does
not divide the 3 tiles) and 5 blocks (two of them empty):

- float32: every gradient, normalized by its largest entry, within 5e-6 (the JAX
  kernels' own bound against their oracle; the same f32 math in another order); the
  loss within 1e-5 relative, the confusion matrix equal.
- bfloat16: relative L2 <= 2e-3 for every gradient, as the single-kernel plain
  version's tests.

The twins composed (``final_head_loss_bwd_sequence_plain``) are also held to
``final_head_loss_bwd_plain`` within the same limits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch.ops import final_head as fh
from heal_swin_tpu.ops import final_head as jfh

F32_TOL = 5e-6
BF16_REL_L2 = 2e-3
LOSS_RTOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
T, P, F = 320, 4, 10
GRIDS = (1, 2, 5)
SCALE = 1.7  # the loss gradient


def _operands(C, seed):
    """x, we, gamma, beta, wh, y, welem: numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(T, C)).astype(f), (rng.normal(size=(C, P * C)) * 0.2).astype(f),
            (1.0 + 0.3 * rng.normal(size=C)).astype(f), (0.2 * rng.normal(size=C)).astype(f),
            (rng.normal(size=(C, F)) * 0.3).astype(f),
            rng.integers(0, F, (T, P)).astype(np.int32),
            rng.uniform(0.5, 2.0, (T, P)).astype(f))


def _torch_ops(C, dtype):
    """The torch operands: x in the dtype under test, the rest f32 (y int)."""
    x, *rest = _operands(C, seed=C)
    return (torch.from_numpy(x).to(DTYPES[dtype][1]),) + tuple(torch.from_numpy(a)
                                                               for a in rest)


@functools.lru_cache(maxsize=None)
def _pallas(C, dtype):
    """(loss, confusion matrix, (dx, dwe, dgamma, dbeta, dwh)) of the Pallas tail in
    interpret mode, for a loss gradient of SCALE."""
    x, we, g, b, wh, y, w = _operands(C, seed=C)

    def fn(x, we, g, b, wh):
        return jfh.fused_final_head(x, we, g, b, wh, jnp.asarray(y), jnp.asarray(w),
                                    patch_size=P, interpret=True, rblk=64)

    (loss, cm), vjp = jax.vjp(fn, jnp.asarray(x, DTYPES[dtype][0]),
                              *(jnp.asarray(a) for a in (we, g, b, wh)))
    grads = vjp((jnp.asarray(SCALE, jnp.float32), jnp.zeros_like(cm)))
    return float(loss), np.asarray(cm), tuple(np.asarray(jnp.asarray(a, jnp.float32))
                                              for a in grads)


def _assert_grad(got, want, dtype, name):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy().reshape(want.shape)
    assert np.isfinite(got).all(), name
    if dtype == "float32":
        scale = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=F32_TOL,
                                   err_msg=name)
    else:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= BF16_REL_L2, (name, err)


def _scale(ops):
    """scale = gloss / sum w, as the autograd function hands K7."""
    return torch.tensor(SCALE) / ops[6].sum()


CASES = [pytest.param(C, dtype, grid, id=f"C{C}-{dtype}-grid{grid}")
         for C in (32, 96) for dtype in DTYPES for grid in GRIDS]


@pytest.mark.parametrize("C,dtype,grid", CASES)
def test_loss_partials_plain_sum_to_the_plain_loss(C, dtype, grid):
    """K6's partial rows over a persistent block walk: their sum is
    ``final_head_loss_plain``'s (num, den, confusion matrix), and the loss and the
    confusion matrix are the Pallas kernel's."""
    ops = _torch_ops(C, dtype)
    part = fh.final_head_loss_partials_plain(*ops, patch_size=P, grid=grid)
    assert part.shape == (grid, 2 + F * F) and part.dtype == torch.float32
    num, den, cm = fh.final_head_loss_plain(*ops, patch_size=P)
    total = fh.reduce_rows_plain(part)
    np.testing.assert_allclose(float(total[0]), float(num), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(total[1]), float(den), rtol=LOSS_RTOL)
    assert torch.equal(total[2:].reshape(F, F), cm)
    loss, jcm, _ = _pallas(C, dtype)
    np.testing.assert_allclose(float(total[0] / total[1]), loss, rtol=LOSS_RTOL)
    np.testing.assert_array_equal(total[2:].reshape(F, F).numpy(), jcm)


@pytest.mark.parametrize("C,dtype,grid", CASES)
def test_bwd_rows_plain_matches_pallas(C, dtype, grid):
    """The row step's twin: dx, and through the other two twins dWe (x^T dh), dgamma,
    dbeta and dWh from its partial rows, against the Pallas backward."""
    ops = _torch_ops(C, dtype)
    dx, dh, part = fh.final_head_loss_bwd_rows_plain(*ops, _scale(ops), patch_size=P,
                                                     grid=grid)
    assert dx.dtype == dh.dtype == ops[0].dtype
    assert dh.shape == (T, P * C) and part.shape == (grid, C * F + 2 * C)
    dwh, dg, db = fh.reduce_rows_plain(part).split([C * F, C, C])
    got = (dx, fh.final_head_loss_dwe_plain(ops[0], dh), dg, db, dwh)
    for name, g, w in zip(("dx", "dwe", "dgamma", "dbeta", "dwh"), got, _pallas(C, dtype)[2]):
        _assert_grad(g, w, dtype, name)


@pytest.mark.parametrize("C,dtype,grid", CASES)
def test_bwd_sequence_plain_matches_the_plain_backward(C, dtype, grid):
    """The three twins composed against the single-kernel plain version of K7."""
    ops = _torch_ops(C, dtype)
    seq = fh.final_head_loss_bwd_sequence_plain(*ops, _scale(ops), patch_size=P, grid=grid)
    want = fh.final_head_loss_bwd_plain(*ops, _scale(ops), patch_size=P)
    for name, g, w in zip(("dx", "dwe", "dgamma", "dbeta", "dwh"), seq, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _assert_grad(g, w.float().numpy(), dtype, name)
    assert torch.equal(seq[0], want[0])  # dx: the same products in the same order


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sequence_twin_is_the_three_steps_composed(dtype):
    """``final_head_loss_bwd_sequence_plain`` returns the steps' results bit for bit."""
    ops = _torch_ops(32, dtype)
    scale = _scale(ops)
    whole = fh.final_head_loss_bwd_sequence_plain(*ops, scale, patch_size=P, grid=2)
    dx, dh, part = fh.final_head_loss_bwd_rows_plain(*ops, scale, patch_size=P, grid=2)
    dwh, dg, db = fh.reduce_rows_plain(part).split([32 * F, 32, 32])
    steps = (dx, fh.final_head_loss_dwe_plain(ops[0], dh), dg, db, dwh.reshape(32, F))
    assert all(torch.equal(a, b) for a, b in zip(whole, steps))


def test_blocks_walk_their_tiles():
    """Block b sums the tiles b, b + grid, ...: with every weight 1, sum w of a block's
    partial row counts the p sub-pixels of its rows, 0 for a block with no tile."""
    ops = list(_torch_ops(32, "float32"))
    ops[6] = torch.ones(T, P)
    for grid, rows in ((1, [320]), (2, [128 + 64, 128]), (3, [128, 128, 64]),
                       (5, [128, 128, 64, 0, 0])):
        part = fh.final_head_loss_partials_plain(*ops, patch_size=P, grid=grid)
        assert part[:, 1].tolist() == [P * r for r in rows], grid
        assert part[:, 2:].sum(1).tolist() == [P * r for r in rows], grid
        zero = part.clone()
        zero[:, 0] = 0  # num is real
        assert all(float(zero[b].abs().sum()) == 0 for b in range(grid) if rows[b] == 0)
    dwh_rows = fh.final_head_loss_bwd_rows_plain(*ops, torch.tensor(1.0), patch_size=P,
                                                 grid=5)[2]
    assert float(dwh_rows[3:].abs().sum()) == 0


def test_step_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors the step wrappers are their twins (the row step on one block) and
    count no launch; the K6 and K7 row wrappers' logits taps are the rounded logits
    K6's cross entropy takes."""
    ops = _torch_ops(32, "bfloat16")
    scale = _scale(ops)
    before, before_shapes = dict(fh.launches), fh.launches_by_shape.copy()
    dx, dh, part, lf7 = fh.final_head_loss_bwd_rows(*ops, scale, patch_size=P,
                                                    tap_logits=True)
    want = fh.final_head_loss_bwd_rows_plain(*ops, scale, patch_size=P, grid=1)
    assert all(torch.equal(a, b) for a, b in zip((dx, dh, part), want))
    assert torch.equal(fh.final_head_loss_dwe(ops[0], dh),
                       fh.final_head_loss_dwe_plain(ops[0], dh))
    assert torch.equal(fh.reduce_rows(part), fh.reduce_rows_plain(part))
    num, den, cm, lf6 = fh.final_head_loss_sums(*ops, patch_size=P, tap_logits=True)
    sums = fh.final_head_loss_plain(*ops, patch_size=P)
    assert all(torch.equal(a, b) for a, b in zip((num, den, cm), sums))
    logits = fh.final_head_logits_plain(*ops[:5], patch_size=P).to(ops[0].dtype)
    assert logits.shape == (T, P, F) and logits.dtype == torch.bfloat16
    assert torch.equal(lf6, logits) and torch.equal(lf7, logits)
    assert fh.launches == before and fh.launches_by_shape == before_shapes


def test_loss_kernels_take():
    """K6 and K7, and K3 on their row core, take C in 32, 64, 96, 128 (one instantiation
    each); other multiples of 16 are refused."""
    bf = torch.bfloat16
    for C in (32, 64, 96, 128):
        assert fh.kernels_take(262144, C, 10, bf)
        assert fh.kernels_take(262144, C, 10, bf, train=False), C
    for C in (16, 48, 80, 112, 144, 160):
        assert not fh.kernels_take(262144, C, 10, bf), C
        assert not fh.kernels_take(262144, C, 10, bf, train=False), C
    assert fh.kernels_take(128, 96, 32, bf) and not fh.kernels_take(128, 96, 33, bf)
    assert not fh.kernels_take(96, 96, 10, bf)  # T % 64
    assert not fh.kernels_take(128, 96, 10, torch.float32)
