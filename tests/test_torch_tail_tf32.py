"""The arithmetic of the f32 decoder-tail kernels, held against the JAX package.

The f32 K6/K7 and K8/K9 (``csrc/tail_f32.cuh``) run every product on the tensor cores in
3xTF32 (``heal_swin_torch.ops.tf32``).  Here their functions are composed on the CPU in
the kernels' walk -- the expand slices in an outer loop, each over 128-row tiles -- with
every product through ``matmul_3xtf32``: the expand h = x We_i, the head z Wh, dz =
dlogits Wh^T, dx += dh We_i^T, and the per-tile sums dWe_i += x^T dh and dWh += z^T
dlogits.  They are held to the Pallas kernels with f32 operands in interpret mode
(``fused_final_head``, ``fused_final_head_depth`` and their ``jax.vjp``) at the paper
config's tail widths (C 96, p 4; T 320: two full tiles and a half one): the cross entropy
with 8 classes, the depth loss l2 with one channel and nll with two.  The limit is the
kernels' own on the card, 1e-5: relative on the loss, relative L2 on every gradient.  The
same composition with a single TF32 pass (``matmul_tf32``) misses it: every gradient by
more than 10 times (1.2e-4 to 3.8e-3), the loss by 2x to 120x.  The test asserts the miss,
so that it guards the choice of 3xTF32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch.ops import final_head as fh
from heal_swin_torch.ops import tf32
from heal_swin_tpu.ops import final_head as jfh

TOL = 1e-5  # F32_TAIL_TOL of chip_smoke.py: the f32 kernels against their plain versions
T, C, P = 320, 96, 4
TILE = 128  # token rows of a tile (fh.TAIL_TILE_ROWS)
GLOSS = 0.9
MATMULS = {3: tf32.matmul_3xtf32, 1: tf32.matmul_tf32}
GRADS = ("dx", "dwe", "dgamma", "dbeta", "dwh")
# (loss, F): the segmentation paper head and the depth heads of the two depth losses
LOSSES = (("ce", 8), ("l2", 1), ("nll", 2))


@functools.lru_cache(maxsize=None)
def _operands(loss, F):
    """numpy inputs: x ~ N(0, 1), We and Wh at std 0.2 and 0.3, LayerNorm near identity;
    class targets and weights in [0.5, 2), or depth targets N(1, 1) with 35% inf."""
    rng = np.random.default_rng(21 + F)
    f = np.float32
    ops = (rng.normal(size=(T, C)).astype(f), (rng.normal(size=(C, P * C)) * 0.2).astype(f),
           (1.0 + 0.3 * rng.normal(size=C)).astype(f), (0.2 * rng.normal(size=C)).astype(f),
           (rng.normal(size=(C, F)) * 0.3).astype(f))
    if loss == "ce":
        return ops + (rng.integers(0, F, (T, P)).astype(np.int32),
                      rng.uniform(0.5, 2.0, (T, P)).astype(f))
    tgt = rng.normal(1.0, 1.0, size=(T, P)).astype(f)
    tgt[rng.uniform(size=(T, P)) < 0.35] = np.inf
    return ops + (tgt,)


@functools.lru_cache(maxsize=None)
def _pallas(loss, F):
    """(loss, (dx, dwe, dgamma, dbeta, dwh)) of the Pallas kernel in interpret mode, in
    f32, for a loss gradient of GLOSS."""
    ops = _operands(loss, F)
    if loss == "ce":
        y, w = (jnp.asarray(a) for a in ops[5:])

        def fn(*a):
            return jfh.fused_final_head(*a, y, w, patch_size=P, interpret=True, rblk=64)
    else:
        t = jnp.asarray(ops[5])

        def fn(*a):
            return jfh.fused_final_head_depth(*a, t, patch_size=P, loss_kind=loss,
                                              interpret=True, rblk=64)

    (value, aux), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in ops[:5]))
    grads = vjp((jnp.asarray(GLOSS, jnp.float32), jnp.zeros_like(aux)))
    return float(value), tuple(np.asarray(a) for a in grads)


def _ce(lf, y, w):
    """(sum w * nll, dlogits / scale) of a tile's f32 logits (rows, F)."""
    sm = torch.softmax(lf, -1)
    onehot = torch.nn.functional.one_hot(y.long(), lf.shape[-1]).float()
    nll = torch.logsumexp(lf, -1) - (lf * onehot).sum(-1)
    return (w * nll).sum(), w[:, None] * (sm - onehot)


def _depth(lf, t, kind):
    """(sum loss, dloss/dlogits) of a tile's f32 logits (rows, F), 0 where t is not
    finite (``_depth_loss_vals`` / ``_depth_loss_grads``)."""
    vals, _ = fh._depth_loss_vals(lf, t, kind, 1.0)
    return vals.sum(), fh._depth_loss_grads(lf, t, kind, 1.0)


def _tail_walk(loss, F, mm):
    """The f32 tail's loss and gradients in the kernels' walk, every product through
    ``mm``: (loss, (dx, dwe, dgamma, dbeta, dwh))."""
    ops = [torch.from_numpy(a) for a in _operands(loss, F)]
    x, we, gamma, beta, wh = ops[:5]
    we_s = we.reshape(C, P, C).permute(1, 0, 2)
    den = ops[6].sum() if loss == "ce" else torch.isfinite(ops[5]).sum().float()
    scale = GLOSS / torch.clamp_min(den, 1.0 if loss != "ce" else 1e-12)
    num = torch.zeros(())
    dx = torch.zeros(T, C)
    dwh, dg, db = torch.zeros(C, F), torch.zeros(C), torch.zeros(C)
    dwe = []
    for i in range(P):
        dwe_i = torch.zeros(C, C)
        for r in range(0, T, TILE):
            xt = x[r:r + TILE]
            h = mm(xt, we_s[i])
            xc = h - h.mean(-1, keepdim=True)
            rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + fh.LN_EPS)
            xhat = xc * rstd
            z = xhat * gamma + beta
            lf = mm(z, wh)
            if loss == "ce":
                s, dl = _ce(lf, ops[5][r:r + TILE, i], ops[6][r:r + TILE, i])
            else:
                s, dl = _depth(lf, ops[5][r:r + TILE, i], loss)
            num = num + s
            dl = scale * dl
            dz = mm(dl, wh.t())
            dzh = dz * gamma
            dh = rstd * (dzh - dzh.mean(-1, keepdim=True)
                         - xhat * (dzh * xhat).mean(-1, keepdim=True))
            dx[r:r + TILE] += mm(dh, we_s[i].t())
            dwe_i = dwe_i + mm(xt.t(), dh)
            dwh = dwh + mm(z.t(), dl)
            dg = dg + (dz * xhat).sum(0)
            db = db + dz.sum(0)
        dwe.append(dwe_i)
    value = num / torch.clamp_min(den, 1.0 if loss != "ce" else 1e-12)
    return float(value), (dx, torch.cat(dwe, dim=1), dg, db, dwh)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("loss,F", LOSSES)
def test_tail_3xtf32_walk_matches_pallas(loss, F):
    """With every product in 3xTF32, the loss and every gradient within 1e-5 of the
    Pallas kernel's; with one TF32 pass, the loss outside 1e-5 and every gradient outside
    10 times that."""
    want_loss, want = _pallas(loss, F)
    got_loss, got = _tail_walk(loss, F, MATMULS[3])
    assert abs(got_loss - want_loss) <= TOL * abs(want_loss), (got_loss, want_loss)
    for name, a, w in zip(GRADS, got, want):
        assert _rel_l2(a, w) <= TOL, (name, _rel_l2(a, w))
    one_loss, one = _tail_walk(loss, F, MATMULS[1])
    assert abs(one_loss - want_loss) > TOL * abs(want_loss), (one_loss, want_loss)
    for name, a, w in zip(GRADS, one, want):
        assert _rel_l2(a, w) > 10 * TOL, (name, _rel_l2(a, w))
