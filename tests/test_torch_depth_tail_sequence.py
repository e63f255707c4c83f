"""K8's partial rows and K9's launch sequence, step by step, against the JAX package on
the CPU.

On the card K8 (``final_head_depth_loss_sums``) and K9's row kernel run on the tail row
core's persistent blocks: block b walks the 128-row tiles b, b + grid, ... and writes one
partial row.  K9 (``final_head_depth_loss_bwd``) launches its row kernel (dx, the rounded
dh of every sub-pixel, partial rows [dWh | dgamma | dbeta] from the f32 dlogits), then
dWe = x^T dh (``gemm_tn``), then the reduction of the partial rows.  Their plain twins,
``final_head_depth_loss_partials_plain``, ``final_head_depth_loss_bwd_rows_plain``,
``final_head_loss_dwe_plain`` and ``reduce_rows_plain``, are held here to the Pallas
kernels of ``heal_swin_tpu/ops/final_head.py`` run in interpret mode
(``fused_final_head_depth(..., interpret=True)`` and its custom VJP under ``jax.vjp``), on
the same numpy inputs, for every loss kind (l2, l1, huber with delta 0.5, nll with a
logvar channel, l2 with one), at C 32 and 96, p 4, T 320 (two full tiles and a half one),
on grids of 1, 2 (which does not divide the 3 tiles) and 5 blocks (two of them empty):

- float32: every gradient, normalized by its largest entry, within 5e-6 (the JAX
  kernels' own bound against their oracle; the same f32 math in another order); the
  loss within 1e-5 relative, the count equal.
- bfloat16: relative L2 <= 2e-3 for every gradient, as the single-kernel plain
  version's tests; the loss within 1e-5 relative.

The twins composed (``final_head_depth_loss_bwd_sequence_plain``) are also held to the
single plain K9, ``final_head_depth_loss_bwd_plain``, within the same limits.
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
T, P = 320, 4
GRIDS = (1, 2, 5)
KINDS = [("l2", 1, 1.0), ("l1", 1, 1.0), ("huber", 1, 0.5), ("nll", 2, 1.0), ("l2", 2, 1.0)]
GLOSS = 1.7  # the loss gradient
GRAD_NAMES = ("dx", "dwe", "dgamma", "dbeta", "dwh")


def _operands(C, F, seed):
    """x, we, gamma, beta, wh, targets (35% inf): numpy.  The targets are N(1, 1) and
    the logits centred at 0, so that dbeta, whose every column is a multiple of the
    dlogits' sum over the rows, is not a sum that cancels to near 0 (where a bound
    normalized by its largest entry says nothing of the code: with N(0, 1) targets one
    case's dbeta came to 0.3% of the other gradients' scale)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    tgt = rng.normal(1.0, 1.0, size=(T, P)).astype(f)
    tgt[rng.uniform(size=(T, P)) < 0.35] = np.inf
    return (rng.normal(size=(T, C)).astype(f), (rng.normal(size=(C, P * C)) * 0.2).astype(f),
            (1.0 + 0.3 * rng.normal(size=C)).astype(f), (0.2 * rng.normal(size=C)).astype(f),
            (rng.normal(size=(C, F)) * 0.3).astype(f), tgt)


def _seed(C, F):
    return C + 7 * F


def _torch_ops(C, F, dtype):
    """The torch operands: x in the dtype under test, the rest f32."""
    x, *rest = _operands(C, F, _seed(C, F))
    return (torch.from_numpy(x).to(DTYPES[dtype][1]),) + tuple(torch.from_numpy(a)
                                                               for a in rest)


@functools.lru_cache(maxsize=None)
def _pallas(C, F, kind, delta, dtype):
    """(loss, (dx, dwe, dgamma, dbeta, dwh)) of the Pallas depth tail in interpret mode,
    for a loss gradient of GLOSS."""
    x, we, g, b, wh, tgt = _operands(C, F, _seed(C, F))

    def fn(x, we, g, b, wh):
        return jfh.fused_final_head_depth(x, we, g, b, wh, jnp.asarray(tgt), patch_size=P,
                                          loss_kind=kind, huber_delta=delta, interpret=True,
                                          rblk=64)

    (loss, preds), vjp = jax.vjp(fn, jnp.asarray(x, DTYPES[dtype][0]),
                                 *(jnp.asarray(a) for a in (we, g, b, wh)))
    grads = vjp((jnp.asarray(GLOSS, jnp.float32), jnp.zeros_like(preds)))
    return float(loss), tuple(np.asarray(jnp.asarray(a, jnp.float32)) for a in grads)


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


def _kw(kind, delta):
    return dict(patch_size=P, loss_kind=kind, huber_delta=delta)


def _scale(ops):
    """scale = gloss / max(count, 1), as the autograd function hands K9."""
    return torch.tensor(GLOSS) / torch.clamp_min(torch.isfinite(ops[5]).sum().float(), 1.0)


CASES = [pytest.param(kind, F, delta, C, dtype, grid,
                      id=f"{kind}-F{F}-C{C}-{dtype}-grid{grid}")
         for kind, F, delta in KINDS for C in (32, 96) for dtype in DTYPES for grid in GRIDS]


@pytest.mark.parametrize("kind,F,delta,C,dtype,grid", CASES)
def test_depth_partials_plain_sum_to_the_plain_loss(kind, F, delta, C, dtype, grid):
    """K8's partial rows over a persistent block walk: their sum is
    ``final_head_depth_loss_plain``'s (sum loss, count), and the loss is the Pallas
    kernel's."""
    ops = _torch_ops(C, F, dtype)
    kw = _kw(kind, delta)
    part = fh.final_head_depth_loss_partials_plain(*ops, **kw, grid=grid)
    assert part.shape == (grid, 2) and part.dtype == torch.float32
    num, den, _ = fh.final_head_depth_loss_plain(*ops, **kw)
    total = fh.reduce_rows_plain(part)
    np.testing.assert_allclose(float(total[0]), float(num), rtol=LOSS_RTOL)
    assert float(total[1]) == float(den) == float(torch.isfinite(ops[5]).sum())
    loss, _ = _pallas(C, F, kind, delta, dtype)
    np.testing.assert_allclose(float(total[0] / torch.clamp_min(total[1], 1.0)), loss,
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("kind,F,delta,C,dtype,grid", CASES)
def test_depth_bwd_rows_plain_matches_pallas(kind, F, delta, C, dtype, grid):
    """The row step's twin: dx, and through the other two twins dWe (x^T dh), dgamma,
    dbeta and dWh from its partial rows, against the Pallas backward."""
    ops = _torch_ops(C, F, dtype)
    dx, dh, part = fh.final_head_depth_loss_bwd_rows_plain(*ops, _scale(ops),
                                                           **_kw(kind, delta), grid=grid)
    assert dx.dtype == dh.dtype == ops[0].dtype
    assert dh.shape == (T, P * C) and part.shape == (grid, C * F + 2 * C)
    dwh, dg, db = fh.reduce_rows_plain(part).split([C * F, C, C])
    got = (dx, fh.final_head_loss_dwe_plain(ops[0], dh), dg, db, dwh)
    for name, g, w in zip(GRAD_NAMES, got, _pallas(C, F, kind, delta, dtype)[1]):
        _assert_grad(g, w, dtype, name)
    if F == 2 and kind != "nll":  # the logvar channel gets no gradient
        assert float(dwh.reshape(C, F)[:, 1].abs().max()) == 0.0


@pytest.mark.parametrize("kind,F,delta,C,dtype,grid", CASES)
def test_depth_bwd_sequence_plain_matches_the_plain_backward(kind, F, delta, C, dtype, grid):
    """The three twins composed against the single-kernel plain version of K9."""
    ops = _torch_ops(C, F, dtype)
    kw = _kw(kind, delta)
    seq = fh.final_head_depth_loss_bwd_sequence_plain(*ops, _scale(ops), **kw, grid=grid)
    want = fh.final_head_depth_loss_bwd_plain(*ops, _scale(ops), **kw)
    for name, g, w in zip(GRAD_NAMES, seq, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _assert_grad(g, w.float().numpy(), dtype, name)
    assert torch.equal(seq[0], want[0])  # dx: the same products in the same order


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind,F,delta", KINDS)
def test_depth_sequence_twin_is_the_three_steps_composed(kind, F, delta, dtype):
    """``final_head_depth_loss_bwd_sequence_plain`` returns the steps' results bit for
    bit."""
    ops = _torch_ops(32, F, dtype)
    kw = _kw(kind, delta)
    scale = _scale(ops)
    whole = fh.final_head_depth_loss_bwd_sequence_plain(*ops, scale, **kw, grid=2)
    dx, dh, part = fh.final_head_depth_loss_bwd_rows_plain(*ops, scale, **kw, grid=2)
    dwh, dg, db = fh.reduce_rows_plain(part).split([32 * F, 32, 32])
    steps = (dx, fh.final_head_loss_dwe_plain(ops[0], dh), dg, db, dwh.reshape(32, F))
    assert all(torch.equal(a, b) for a, b in zip(whole, steps))


def test_depth_blocks_walk_their_tiles():
    """Block b sums the tiles b, b + grid, ...: with every target valid, the count of a
    block's partial row is the p sub-pixels of its rows, and a block with no tile has
    a row of 0 in K8's and K9's partial rows."""
    ops = list(_torch_ops(32, 1, "float32"))
    ops[5] = torch.zeros(T, P)
    kw = _kw("l2", 1.0)
    for grid, rows in ((1, [320]), (2, [128 + 64, 128]), (3, [128, 128, 64]),
                       (5, [128, 128, 64, 0, 0])):
        part = fh.final_head_depth_loss_partials_plain(*ops, **kw, grid=grid)
        assert part[:, 1].tolist() == [P * r for r in rows], grid
        assert all(float(part[b].abs().sum()) == 0 for b in range(grid) if rows[b] == 0)
        assert all(float(part[b, 0]) > 0 for b in range(grid) if rows[b])
    bwd = fh.final_head_depth_loss_bwd_rows_plain(*ops, torch.tensor(1.0), **kw, grid=5)[2]
    assert float(bwd[3:].abs().sum()) == 0 and float(bwd[:3].abs().sum()) > 0


@pytest.mark.parametrize("kind,F,delta", KINDS)
def test_depth_step_wrappers_run_the_plain_versions_on_the_cpu(kind, F, delta):
    """On CPU tensors the step wrappers are their twins (the row step on one block) and
    count no launch; K8's and K9's row wrappers' logits taps are the f32 logits the loss
    takes, and K8's predictions are the tap rounded to x's dtype."""
    ops = _torch_ops(32, F, "bfloat16")
    kw = _kw(kind, delta)
    scale = _scale(ops)
    before, before_shapes = dict(fh.launches), fh.launches_by_shape.copy()
    dx, dh, part, lf9 = fh.final_head_depth_loss_bwd_rows(*ops, scale, **kw, tap_logits=True)
    want = fh.final_head_depth_loss_bwd_rows_plain(*ops, scale, **kw, grid=1)
    assert all(torch.equal(a, b) for a, b in zip((dx, dh, part), want))
    assert torch.equal(fh.final_head_loss_dwe(ops[0], dh),
                       fh.final_head_loss_dwe_plain(ops[0], dh))
    assert torch.equal(fh.reduce_rows(part), fh.reduce_rows_plain(part))
    num, den, preds, lf8 = fh.final_head_depth_loss_sums(*ops, **kw, tap_logits=True)
    sums = fh.final_head_depth_loss_plain(*ops, **kw)
    assert all(torch.equal(a, b) for a, b in zip((num, den, preds), sums))
    logits = fh.final_head_logits_plain(*ops[:5], patch_size=P)
    assert logits.shape == (T, P, F) and logits.dtype == torch.float32
    assert torch.equal(lf8, logits) and torch.equal(lf9, logits)
    assert torch.equal(preds, lf8.reshape(T, P * F).to(ops[0].dtype))
    assert fh.launches == before and fh.launches_by_shape == before_shapes
