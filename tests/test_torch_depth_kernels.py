"""The plain versions of the fused depth tail K8 (forward) and K9 (backward) against
the JAX package's Pallas kernel on the CPU, and the depth building blocks around
them: the autograd function, the unfused depth losses, the depth metric state, and
the depth data stats and transforms.

K8/K9's plain versions are held against ``fused_final_head_depth`` run in interpret
mode and its custom VJP (``jax.vjp``), on the same numpy inputs, C 32, p 4, for every
loss kind (l2, l1, huber, nll, and l2 with a logvar channel):

- float32: the loss rtol 1e-6, the predictions rtol 1e-5; every gradient,
  normalized by its largest entry, within 5e-6 (the same f32 math in another order).
- bfloat16 (T 1024): the loss within relative 3e-5, the predictions and every
  gradient within relative L2 2e-3.  Both sides round at the same points (We and Wh
  to bf16; h after the expand product; z after the LayerNorm; the emitted
  predictions; dh before the expand products) and keep the logits and dlogits in
  f32; they differ only where f32 sums taken in another order flip a rounding:
  measured <= 1.1e-5 (loss, nll), <= 3.5e-5 (predictions) and <= 1.6e-4
  (gradients).  Leaving out any one of those rounding points, or rounding the
  logits or the dlogits, moves the predictions or some gradient by >= 2.6e-3 in some
  case, so the bounds pin each of them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch.data import normalize_depth_data as tnd
from heal_swin_torch.evaluation import metrics as tm
from heal_swin_torch.models import tasks as ttasks
from heal_swin_torch.ops import final_head as fh
from heal_swin_torch.training import losses as tl
from heal_swin_tpu.data import normalize_depth_data as jnd
from heal_swin_tpu.evaluation import metrics as jm
from heal_swin_tpu.models import tasks as jtasks
from heal_swin_tpu.ops import final_head as jfh
from heal_swin_tpu.training import losses as jl

F32_TOL = 5e-6
BF16_REL_L2 = 2e-3
BF16_LOSS_RTOL = 3e-5
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
C, P = 32, 4
KINDS = [("l2", 1, 1.0), ("l1", 1, 1.0), ("huber", 1, 0.7), ("nll", 2, 1.0),
         ("l2", 2, 1.0)]  # l2 with a logvar channel: the phase before the NLL switch
GRAD_NAMES = ["dx", "dwe", "dgamma", "dbeta", "dwh"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _operands(seed, F, t=256, background=0.3):
    rng = np.random.default_rng(seed)
    f = np.float32
    tgt = rng.normal(size=(t, P)).astype(f)
    tgt[rng.uniform(size=(t, P)) < background] = np.inf
    return (rng.normal(size=(t, C)).astype(f), (rng.normal(size=(C, P * C)) * 0.2).astype(f),
            (1.0 + 0.3 * rng.normal(size=C)).astype(f), (0.2 * rng.normal(size=C)).astype(f),
            (rng.normal(size=(C, F)) * 0.3).astype(f), tgt)


def _pallas(ops, jdt, kind, delta, gloss=1.7):
    """fused_final_head_depth in interpret mode: (loss, preds, gradients of x, we,
    gamma, beta, wh for loss gradient ``gloss``)."""
    x, we, g, b, wh, tgt = ops

    def fn(x, we, g, b, wh):
        return jfh.fused_final_head_depth(x, we, g, b, wh, jnp.asarray(tgt), patch_size=P,
                                          loss_kind=kind, huber_delta=delta, interpret=True,
                                          rblk=128)

    (loss, preds), vjp = jax.vjp(fn, jnp.asarray(x, jdt), *(jnp.asarray(a) for a in (we, g, b, wh)))
    return loss, preds, vjp((jnp.asarray(gloss, jnp.float32), jnp.zeros_like(preds)))


def _plain(ops, tdt, kind, delta, gloss=1.7):
    x, we, g, b, wh, tgt = ops
    args = (_t(x).to(tdt), _t(we), _t(g), _t(b), _t(wh), _t(tgt))
    kw = dict(patch_size=P, loss_kind=kind, huber_delta=delta)
    num, den, preds = fh.final_head_depth_loss_plain(*args, **kw)
    den_s = torch.clamp_min(den, 1.0)
    grads = fh.final_head_depth_loss_bwd_plain(*args, torch.tensor(gloss) / den_s, **kw)
    return num / den_s, preds, grads


def _assert_grad(got, want, dtype, name):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy().reshape(want.shape)
    assert np.isfinite(got).all(), name
    if dtype == "float32":
        scale = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(got / scale, want / scale, atol=F32_TOL, err_msg=name)
    else:
        err = _rel_l2(got, want)
        assert err <= BF16_REL_L2, (name, err)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind,F,delta", KINDS)
def test_depth_tail_plain_matches_pallas(kind, F, delta, dtype):
    """K8's plain version (loss, predictions) and K9's (every gradient, for a loss
    gradient of 1.7) against ``fused_final_head_depth`` and its custom VJP."""
    jdt, tdt = DTYPES[dtype]
    ops = _operands(0, F, 256 if dtype == "float32" else 1024)
    loss_j, preds_j, grads_j = _pallas(ops, jdt, kind, delta)
    loss_t, preds_t, grads_t = _plain(ops, tdt, kind, delta)
    assert preds_t.dtype == tdt and tuple(preds_t.shape) == tuple(preds_j.shape)
    pj = np.asarray(preds_j.astype(jnp.float32))
    pt = preds_t.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
        np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=BF16_LOSS_RTOL)
        assert _rel_l2(pt, pj) <= BF16_REL_L2
    for name, g, w in zip(GRAD_NAMES, grads_t, grads_j):
        _assert_grad(g, w, dtype, name)
    if F == 2 and kind != "nll":  # the logvar channel gets no gradient
        assert float(grads_t[4][:, 1].abs().max()) == 0.0


@pytest.mark.parametrize("kind,F,delta", KINDS)
def test_depth_tail_all_background(kind, F, delta):
    """Every target inf: the count is 0 and clamps to 1, the loss is 0, and every
    gradient is exactly 0 (no NaN), as in the Pallas kernel."""
    ops = _operands(1, F, background=1.0)
    loss_j, _, grads_j = _pallas(ops, jnp.float32, kind, delta)
    loss_t, _, grads_t = _plain(ops, torch.float32, kind, delta)
    assert float(loss_t) == float(loss_j) == 0.0
    for name, g, w in zip(GRAD_NAMES, grads_t, grads_j):
        assert np.all(np.asarray(w) == 0.0), name
        assert torch.equal(g, torch.zeros_like(g)), name


def test_depth_tail_nan_targets_are_excluded():
    """A NaN target is invalid on this route (isfinite), as in the Pallas kernel: the
    results equal those with inf in its place."""
    ops = list(_operands(2, 2))
    ops[5][3, 1] = np.nan
    ops[5][10, :] = np.nan
    loss_j, _, grads_j = _pallas(ops, jnp.float32, "nll", 1.0)
    loss_t, _, grads_t = _plain(ops, torch.float32, "nll", 1.0)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    for name, g, w in zip(GRAD_NAMES, grads_t, grads_j):
        _assert_grad(g, w, "float32", name)
    inf_ops = list(ops)
    inf_ops[5] = np.where(np.isnan(ops[5]), np.inf, ops[5]).astype(np.float32)
    loss_i, _, grads_i = _plain(inf_ops, torch.float32, "nll", 1.0)
    assert torch.equal(loss_t, loss_i)
    assert all(torch.equal(a, b) for a, b in zip(grads_t, grads_i))


@pytest.mark.parametrize("kind,F,delta", KINDS)
def test_depth_loss_function_matches_autograd_of_plain(kind, F, delta):
    """On CPU tensors ``final_head_depth_loss`` runs K8's and K9's plain versions; its
    gradients equal torch autograd through the plain forward (f32), and its
    predictions carry no gradient."""
    ops = _operands(3, F)
    kw = dict(patch_size=P, loss_kind=kind, huber_delta=delta)
    res = []
    for fused in (True, False):
        leaves = [_t(a).requires_grad_() for a in ops[:5]]
        if fused:
            loss, preds = fh.final_head_depth_loss(*leaves, _t(ops[5]), **kw)
            assert not preds.requires_grad
        else:
            num, den, _ = fh.final_head_depth_loss_plain(*leaves, _t(ops[5]), **kw)
            loss = num / torch.clamp_min(den, 1.0)
        (1.3 * loss).backward()
        res.append((float(loss.detach()), [t.grad for t in leaves]))
    assert res[0][0] == res[1][0]
    for name, g, w in zip(GRAD_NAMES, res[0][1], res[1][1]):
        scale = float(w.abs().max()) + 1e-12
        np.testing.assert_allclose(g.numpy() / scale, w.numpy() / scale, atol=F32_TOL,
                                   err_msg=name)


def test_depth_kernels_take():
    """The shapes, kinds and dtypes K8/K9 take: C % 8 == 0 up to 192 (on the tail row cores
    at C 32, 64, 96, 128 where the slices fit, the wide route elsewhere), bf16 or f32, F 1
    or 2 (nll needs 2), T % 64.  The depth task's fused gate (``supported_depth``) is
    the JAX task's: C % 8 == 0, F in {1, 2}, T % 128 == 0, bf16 or
    f32, with no bound on C, so on the card a tail above C 192 raises."""
    f32, bf = torch.float32, torch.bfloat16
    for C in (8, 16, 40, 48, 96, 136, 192):
        for dt in (f32, bf):
            assert fh.depth_kernels_take(262144, C, 1, "l2", dt), C
            assert fh.depth_kernels_take(128, C, 2, "nll", dt), C
            assert fh.depth_kernels_take(128, C, 1, "huber", dt), C
            assert not fh.depth_kernels_take(128, C, 1, "nll", dt), C
    assert not fh.depth_kernels_take(128, 200, 1, "l2", f32)  # above C 192
    assert not fh.depth_kernels_take(96, 32, 1, "l2", f32)  # T % 64
    assert not fh.depth_kernels_take(128, 32, 1, "l2", torch.float16)
    assert fh.depth_kernels_take(262144, 96, 1, "l2")
    assert fh.depth_kernels_take(128, 128, 1, "l2")
    assert not fh.depth_kernels_take(128, 32, 1, "nll")  # nll needs a logvar channel
    assert not fh.depth_kernels_take(128, 32, 3, "l2")
    assert not fh.depth_kernels_take(128, 32, 1, "ce")
    assert not fh.depth_kernels_take(96, 32, 1, "l2")  # T % 64
    assert not fh.depth_kernels_take(128, 44, 1, "l2")  # C % 8
    for C in (8, 16, 48, 80, 112, 200, 384):  # C % 8, no bound on C
        assert fh.supported_depth(128, C, 1, 4, bf), C
        assert fh.supported_depth(128, C, 2, 4, f32), C
    assert not fh.supported_depth(128, 44, 1, 4, bf)
    assert not fh.supported_depth(64, 32, 1, 4, bf)  # T % 128
    assert not fh.supported_depth(128, 32, 3, 4, bf)
    assert not fh.supported_depth(128, 32, 1, 4, torch.float16)


LOSSES = [("mse", {}), ("l1_loss", {}), ("huber_loss", {"delta": 0.7}),
          ("mean_log_var_loss", {})]


@pytest.mark.parametrize("name,kw", LOSSES)
def test_depth_losses_match_jax(name, kw):
    """Value and gradient of each unfused depth loss with inf-marked targets (every
    target of the second sample inf, and a zero difference for l1's sign)."""
    rng = np.random.default_rng(4)
    preds = rng.normal(size=(3, 40, 2)).astype(np.float32)
    target = rng.normal(size=(3, 40)).astype(np.float32)
    target[rng.uniform(size=target.shape) < 0.3] = np.inf
    target[1] = np.inf
    target[0, 5] = preds[0, 5, 0]
    jfn = functools.partial(getattr(jl, name), **kw)
    want, gj = jax.value_and_grad(jfn)(jnp.asarray(preds), jnp.asarray(target))
    pt = _t(preds).requires_grad_()
    got = functools.partial(getattr(tl, name), **kw)(pt, _t(target))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert np.isfinite(pt.grad.numpy()).all()
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-7)
    # every target inf: the mean divides by max(count, 1) and is 0
    assert float(getattr(tl, name)(pt, torch.full((3, 40), float("inf")))) == 0.0


@pytest.mark.parametrize("use_logvar,loss,delta", [(False, "l2", 1.0), (False, "l1", 1.0),
                                                   (False, "huber", 0.3), (True, "l1", 1.0)])
def test_get_depth_loss_matches_jax(use_logvar, loss, delta):
    """The loss a CommonDepthConfig selects: the NLL from the start with use_logvar."""
    jfn = jl.get_depth_loss(jtasks.CommonDepthConfig(loss=loss, use_logvar=use_logvar,
                                                     huber_delta=delta))
    tfn = tl.get_depth_loss(ttasks.CommonDepthConfig(loss=loss, use_logvar=use_logvar,
                                                     huber_delta=delta))
    rng = np.random.default_rng(5)
    preds = (rng.normal(size=(2, 30, 2)) * 2).astype(np.float32)
    target = rng.normal(size=(2, 30)).astype(np.float32)
    np.testing.assert_allclose(float(tfn(_t(preds), _t(target))),
                               float(jfn(jnp.asarray(preds), jnp.asarray(target))), rtol=1e-6)


@pytest.mark.parametrize("with_logvar", [False, True])
def test_depth_state_matches_jax(with_logvar):
    """Two updates with inf, zero and negative depths (and a NaN prediction), then the
    epoch metrics, against the JAX package's."""
    rng = np.random.default_rng(6)
    pred = rng.uniform(0.1, 60.0, size=(2, 3, 50)).astype(np.float32)
    target = rng.uniform(0.1, 60.0, size=(2, 3, 50)).astype(np.float32)
    target[rng.uniform(size=target.shape) < 0.3] = np.inf
    target[0, 0, :4] = 0.0
    pred[1, 1, :3] = 0.0
    pred[0, 2, 7] = -2.0
    pred[1, 0, 9] = np.nan
    lv = rng.normal(size=pred.shape).astype(np.float32)
    sj, st = jm.depth_state_init(), tm.depth_state_init("cpu")
    for k in range(2):
        kw_j = dict(log_var=jnp.asarray(lv[k])) if with_logvar else {}
        kw_t = dict(log_var=_t(lv[k])) if with_logvar else {}
        sj = jm.depth_state_update(sj, jnp.asarray(pred[k]), jnp.asarray(target[k]),
                                   dataset_mean=13.65, **kw_j)
        st = tm.depth_state_update(st, _t(pred[k]), _t(target[k]), dataset_mean=13.65, **kw_t)
    assert set(st) == set(sj)
    for k in sj:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), rtol=1e-6, err_msg=k)
    want = jm.depth_state_compute(sj, "val_")
    got = tm.depth_state_compute(st, "val_")
    assert list(got) == list(want)
    assert ("val_mean_std" in got) == with_logvar
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], rtol=1e-6)


def test_depth_stats_match_jax():
    """Every stats class's constants, through get_depth_data_stats."""
    for transform in (None, "None", "log", "inv"):
        for masked in (False, True):
            j = jnd.get_depth_data_stats(transform, masked)
            t = tnd.get_depth_data_stats(transform, masked)
            assert type(t).__name__ == type(j).__name__
            assert vars(t) == vars(j)
            assert str(t) == str(j)


@pytest.mark.parametrize("transform", [None, "None", "log", "inv"])
@pytest.mark.parametrize("norm", [None, "None", "standardize", "min-max"])
def test_depth_transforms_match_jax(transform, norm):
    """transform_and_normalize and its inverse, with inf and below-1e-3 depths."""
    x = np.asarray([[0.5, 2.0, 60.0, np.inf, 1e-4, 0.0, 1e-3, 999.0]], np.float32)
    stats_j = jnd.get_depth_data_stats(transform, True)
    stats_t = tnd.get_depth_data_stats(transform, True)
    fwd_j = jnd.transform_and_normalize(jnp.asarray(x), norm, stats_j, transform)
    fwd_t = tnd.transform_and_normalize(_t(x), norm, stats_t, transform)
    np.testing.assert_allclose(fwd_t.numpy(), np.asarray(fwd_j), rtol=1e-6)
    back_j = jnd.unnormalize_and_retransform(fwd_j, norm, stats_j, transform)
    back_t = tnd.unnormalize_and_retransform(fwd_t, norm, stats_t, transform)
    np.testing.assert_allclose(back_t.numpy(), np.asarray(back_j), rtol=1e-5)


def test_inverse_mask_matches_jax():
    """inf -> 0, values below 1e-3 -> inf, the rest 1/x; its own inverse."""
    x = np.asarray([np.inf, -np.inf, 0.0, 5e-4, -3.0, 1e-3, 0.25, 4.0, np.nan], np.float32)
    got = tnd.inverse_mask(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnd.inverse_mask(jnp.asarray(x))))
    np.testing.assert_array_equal(got[:3], [0.0, 0.0, np.inf])
    assert got[4] == np.inf and got[6] == 4.0
    np.testing.assert_array_equal(tnd.inverse_mask(_t(got[6:8])).numpy(), x[6:8])
