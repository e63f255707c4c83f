"""The plain versions of the backward kernels K4 (K1's backward), K5 (K2's backward)
and the fused CE tail K6/K7 against the JAX package on the CPU, and the training
building blocks around them: the autograd functions, the weighted cross entropy, the
segmentation metric state, the optimizer, the token permutation's backward,
LayerNorm's backward and DropPath's generator.

The backward plain versions are held against ``jax.vjp`` of the Pallas kernels run in
interpret mode (``fused_window_attention_qkv_epi``, ``fused_window_attention``,
``fused_final_head``) on the same numpy inputs, ws 16, C 32, 2 heads:

- float32: every gradient, normalized by its largest entry, within 5e-6 (the JAX
  kernels' own bound against their oracle; the same f32 math in another order).
- bfloat16: relative L2 <= 2e-3 for every gradient.  Both sides round at the same
  points (qkv; (q/|q|)*scale and k/|k|; p before dv; ds before the q/k products; du
  before dWp and do; do; dqkv before dx and dW; the weight gradients to bf16 as the
  JAX custom VJP returns them; for the tail the logits, dlogits and dh), and differ
  only where f32 sums taken in another order flip a rounding: measured <= 1.6e-4.
  Leaving out any one of those rounding points (15 in all) moves some gradient by
  >= 2.6e-3 relative L2, so the bound pins each of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch.evaluation import metrics as tm
from heal_swin_torch.models.layers import DropPath, LayerNorm
from heal_swin_torch.ops import final_head as fh
from heal_swin_torch.ops import window_attention as wa
from heal_swin_torch.ops.permute import permute_tokens
from heal_swin_torch.training import losses as tl
from heal_swin_torch.training import optimizer as topt
from heal_swin_tpu.evaluation import metrics as jm
from heal_swin_tpu.ops import final_head as jfh
from heal_swin_tpu.ops.window_attention import (
    fused_window_attention,
    fused_window_attention_qkv_epi,
)
from heal_swin_tpu.training import losses as jl
from heal_swin_tpu.training import optimizer as jopt

F32_TOL = 5e-6
BF16_REL_L2 = 2e-3
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
WS, H, C, NW = 16, 2, 32, 16
T = WS * NW


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_grad(got, want, dtype, name):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy().reshape(want.shape)
    assert np.isfinite(got).all(), name
    if dtype == "float32":
        scale = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(got / scale, want / scale, atol=F32_TOL, err_msg=name)
    else:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= BF16_REL_L2, (name, err)


def _epi_operands(seed):
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
    )


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("has_mask", [True, False])
@pytest.mark.parametrize("has_ln", [True, False])
def test_qkv_epi_bwd_plain_matches_pallas_vjp(has_ln, has_mask, dtype):
    """K4's plain version: dx and the gradients of Wqkv, bqkv, Wp, bp (in the compute
    dtype, as the JAX custom VJP returns them), LN gamma/beta, bias and logit scale."""
    jdt, tdt = DTYPES[dtype]
    o = _epi_operands(5)
    kw = dict(num_heads=H, sm_scale=0.18, has_mask=has_mask)

    def fn(x, wq, bq, wp, bp, g, b, bias, ls):
        return fused_window_attention_qkv_epi(
            x, wq, bq, wp, bp, g if has_ln else None, b if has_ln else None,
            jnp.asarray(o["groups"]), bias, ls, ws=WS, wblk=4, interpret=True, **kw)

    low = ("x", "wq", "bq", "wp", "bp")
    args = [jnp.asarray(o[k], jdt) for k in low] + [jnp.asarray(o[k]) for k in
                                                    ("gam", "bet", "bias", "ls")]
    _, vjp = jax.vjp(fn, *args)
    want = vjp(jnp.asarray(o["dz"], jdt))
    got = wa.window_attention_qkv_epi_bwd_plain(
        *(_t(o[k]).to(tdt) for k in low), _t(o["gam"]) if has_ln else None,
        _t(o["bet"]) if has_ln else None, _t(o["groups"]), _t(o["bias"]), _t(o["ls"]),
        _t(o["dz"]).to(tdt), ws=WS, **kw)
    names = ["dx", "dwq", "dbq", "dwp", "dbp", "dgamma", "dbeta", "dbias", "dls"]
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        if g is None:
            assert not has_ln and name in ("dgamma", "dbeta")
            continue
        _assert_grad(g.to(tdt) if 1 <= i <= 4 else g, w, dtype, name)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("use_cos", [True, False])
@pytest.mark.parametrize("has_mask", [True, False])
@pytest.mark.parametrize("has_bias", [True, False])
def test_attention_bwd_plain_matches_pallas_vjp(use_cos, has_mask, has_bias, dtype):
    """K5's plain version: dqkv, dbias, dlogit_scale; cosine and scaled-dot."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    qkv = rng.normal(size=(T, 3 * C)).astype(np.float32)
    dout = rng.normal(size=(T, C)).astype(np.float32)
    groups = rng.integers(0, 3, (NW, WS)).astype(np.int32)
    bias = rng.normal(size=(H, WS, WS)).astype(np.float32)
    ls = np.exp(rng.normal(size=H) * 0.3).astype(np.float32)
    kw = dict(num_heads=H, use_cos=use_cos, sm_scale=0.35, has_mask=has_mask)

    def fn(qkv, bias, ls):
        return fused_window_attention(qkv, jnp.asarray(groups), bias if has_bias else None,
                                      ls if use_cos else None, ws=WS, interpret=True, wblk=4,
                                      **kw)

    _, vjp = jax.vjp(fn, jnp.asarray(qkv, jdt), jnp.asarray(bias), jnp.asarray(ls))
    want = vjp(jnp.asarray(dout, jdt))
    got = wa.window_attention_bwd_plain(
        _t(qkv).to(tdt), _t(groups), _t(bias) if has_bias else None,
        _t(ls) if use_cos else None, _t(dout).to(tdt), ws=WS, **kw)
    assert got[0].dtype == tdt and (got[2] is None) == (not use_cos)
    _assert_grad(got[0], want[0], dtype, "dqkv")
    if has_bias:
        _assert_grad(got[1], want[1], dtype, "dbias")
    if use_cos:
        _assert_grad(got[2], want[2], dtype, "dls")


P, F = 4, 5


def _tail_operands(seed, t=256):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(t, C)).astype(f), (rng.normal(size=(C, P * C)) * 0.2).astype(f),
            (1.0 + 0.3 * rng.normal(size=C)).astype(f), (0.2 * rng.normal(size=C)).astype(f),
            (rng.normal(size=(C, F)) * 0.3).astype(f),
            rng.integers(0, F, (t, P)).astype(np.int32),
            rng.uniform(0.5, 2.0, (t, P)).astype(f))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_final_head_loss_plain_matches_pallas(dtype):
    """K6's plain version (loss and confusion matrix) and K7's (every gradient, for a
    loss gradient of 1.7) against ``fused_final_head`` and its custom VJP."""
    jdt, tdt = DTYPES[dtype]
    x, we, g, b, wh, y, w = _tail_operands(0, 256 if dtype == "float32" else 2048)

    def fn(x, we, g, b, wh):
        return jfh.fused_final_head(x, we, g, b, wh, jnp.asarray(y), jnp.asarray(w),
                                    patch_size=P, interpret=True, rblk=128)

    (loss, cm), vjp = jax.vjp(fn, jnp.asarray(x, jdt), *(jnp.asarray(a) for a in (we, g, b, wh)))
    want = vjp((jnp.asarray(1.7, jnp.float32), jnp.zeros_like(cm)))
    ops = (_t(x).to(tdt), _t(we), _t(g), _t(b), _t(wh))
    num, den, tcm = fh.final_head_loss_plain(*ops, _t(y), _t(w), patch_size=P)
    np.testing.assert_allclose(float(num / den), float(loss), rtol=1e-6)
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(cm))
    got = fh.final_head_loss_bwd_plain(*ops, _t(y), _t(w), torch.tensor(1.7) / den,
                                       patch_size=P)
    for name, gt, wt in zip(["dx", "dwe", "dgamma", "dbeta", "dwh"], got, want):
        _assert_grad(gt, wt, dtype, name)


def test_final_head_nan_rows_do_not_alias_confmat():
    """A token whose logits hold a NaN counts in no cell of the confusion matrix
    (the Pallas kernel routes it to no lane instead of (y + 1, class 0))."""
    x, we, g, b, wh, y, w = _tail_operands(1)
    x[3] = np.nan
    _, cm_j = jfh.fused_final_head(*(jnp.asarray(a) for a in (x, we, g, b, wh, y, w)),
                                   patch_size=P, interpret=True, rblk=128)
    _, _, cm = fh.final_head_loss_plain(*(_t(a) for a in (x, we, g, b, wh, y, w)),
                                        patch_size=P)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(cm_j))
    assert float(cm.sum()) == 256 * P - P


def test_autograd_functions_match_autograd_of_plain_forwards():
    """On CPU tensors the functions run the plain forward and the plain backward; their
    gradients equal torch autograd through the plain forwards (f32)."""
    o = _epi_operands(7)
    names = ("x", "wq", "bq", "wp", "bp", "gam", "bet", "bias", "ls")

    def leaves():
        return {k: _t(o[k]).requires_grad_() for k in names}

    kw = dict(ws=WS, num_heads=H, sm_scale=0.18)
    dz = _t(o["dz"])
    for fn in (wa.window_attention_qkv_epi, wa.window_attention_qkv_epi_plain):
        a = leaves()
        out = fn(a["x"], a["wq"], a["bq"], a["wp"], a["bp"], a["gam"], a["bet"],
                 _t(o["groups"]), a["bias"], a["ls"], **kw)
        (out * dz).sum().backward()
        if fn is wa.window_attention_qkv_epi:
            got = {k: v.grad for k, v in a.items()}
        else:
            want = {k: v.grad for k, v in a.items()}
    for k in names:
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(got[k].numpy() / scale, want[k].numpy() / scale,
                                   atol=F32_TOL, err_msg=k)

    qkv = _t(o["x"]) @ _t(o["wq"])
    for use_cos in (True, False):
        res = []
        for fn in (wa.window_attention, wa.window_attention_plain):
            q, bias, ls = (qkv.clone().requires_grad_(), _t(o["bias"]).requires_grad_(),
                           _t(o["ls"]).requires_grad_())
            out = fn(q, _t(o["groups"]), bias, ls if use_cos else None, ws=WS, num_heads=H,
                     use_cos=use_cos, sm_scale=0.3)
            (out * dz).sum().backward()
            res.append((q.grad, bias.grad, ls.grad))
        for g, w in zip(*res):
            if w is None:
                assert g is None
                continue
            scale = float(w.abs().max())
            np.testing.assert_allclose(g.numpy() / scale, w.numpy() / scale, atol=F32_TOL)

    ops = _tail_operands(2)
    res = []
    for fused in (True, False):
        lv = [_t(a).requires_grad_() for a in ops[:5]]
        if fused:
            loss, cm = fh.final_head_loss(*lv, _t(ops[5]), _t(ops[6]), patch_size=P)
            assert not cm.requires_grad
        else:
            num, den, _ = fh.final_head_loss_plain(*lv, _t(ops[5]), _t(ops[6]), patch_size=P)
            loss = num / den
        loss.backward()
        res.append([t.grad for t in lv])
    for g, w in zip(*res):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy() / scale, w.numpy() / scale, atol=F32_TOL)


@pytest.mark.parametrize("with_weights", [True, False])
def test_weighted_cross_entropy_matches_jax(with_weights):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 50, F)).astype(np.float32)
    targets = rng.integers(0, F, (2, 50)).astype(np.int32)
    cw = np.asarray([0.5, 1.0, 2.0, 0.25, 1.5], np.float32) if with_weights else None
    mask = np.asarray([True, False])
    for sm in (None, mask):
        want = jl.weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                         None if cw is None else jnp.asarray(cw),
                                         sample_mask=None if sm is None else jnp.asarray(sm))
        got = tl.weighted_cross_entropy(_t(logits), _t(targets), None if cw is None else _t(cw),
                                        sample_mask=None if sm is None else _t(sm))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_seg_state_matches_jax():
    """Updates from predictions (with a sample mask), a merged confusion matrix, and
    the epoch metrics, including the NaN accuracy on 0/0."""
    rng = np.random.default_rng(4)
    preds = rng.integers(0, F, (3, 40)).astype(np.int32)
    target = rng.integers(0, F, (3, 40)).astype(np.int32)
    mask = np.asarray([True, False, True])
    cm = rng.integers(0, 9, (F, F)).astype(np.float32)
    sj = jm.seg_state_update(jm.seg_state_init(F), jnp.asarray(preds), jnp.asarray(target), F,
                             jnp.asarray(mask))
    sj = jm.seg_state_merge_confmat(sj, jnp.asarray(cm))
    st = tm.seg_state_update(tm.seg_state_init(F), _t(preds), _t(target), F, _t(mask))
    st = tm.seg_state_merge_confmat(st, _t(cm))
    for k in sj:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), err_msg=k)
    names = [f"c{i}" for i in range(F)]
    want = jm.seg_state_compute(sj, "val_", class_names=names)
    got = tm.seg_state_compute(st, "val_", class_names=names)
    assert list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], rtol=1e-6)
    # every target is class 0: the "ignored" accuracy is 0/0
    zeros = np.zeros((1, 8), np.int32)
    empty_j = jm.seg_state_compute(jm.seg_state_update(jm.seg_state_init(F), zeros, zeros, F),
                                   "")
    empty_t = tm.seg_state_compute(tm.seg_state_update(tm.seg_state_init(F), _t(zeros),
                                                       _t(zeros), F), "")
    assert np.isnan(empty_t["acc_ignored"]) and np.isnan(empty_j["acc_ignored"])
    assert empty_t["acc"] == empty_j["acc"] == 1.0


@pytest.mark.parametrize("name,wd,clip", [("Adam", 1e-2, 0.0), ("AdamW", 1e-2, 0.0),
                                          ("Adam", 1e-4, 0.05)])
def test_make_optimizer_matches_jax(name, wd, clip):
    """Four steps of the port's optimizer against the JAX package's optax chain on the
    same parameters and gradients: torch Adam's L2-before-moments decay, AdamW's
    decoupled decay, and clipping by the global norm."""
    rng = np.random.default_rng(5)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(4)]
    tx = jopt.make_optimizer(jopt.OptimizerConfig(optimizer_name=name, learning_rate=0.01,
                                                  weight_decay=wd), gradient_clip_val=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: _t(v).requires_grad_() for k, v in params.items()}
    opt = topt.make_optimizer(tp.values(), topt.OptimizerConfig(
        optimizer_name=name, learning_rate=0.01, weight_decay=wd), gradient_clip_val=clip)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        for k, v in tp.items():
            v.grad = _t(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("strategy", ["ring_shift", "nest_grid_shift"])
def test_permute_tokens_backward_matches_jax(strategy):
    """The gradient of permute_tokens is the gather by the inverse permutation: equal
    to the JAX custom VJP exactly, in f32."""
    from heal_swin_tpu.ops.permute import permute_tokens as jax_permute
    from heal_swin_tpu.ops.shifting import get_shift_spec

    spec = get_shift_spec(strategy, 8 * 16 * 16, 8, 16, 8)
    assert spec.kind == "perm"
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, spec.npix, 5)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_permute(a, jnp.asarray(spec.perm), jnp.asarray(spec.inv_perm)),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    xt = _t(x).requires_grad_()
    perm = torch.as_tensor(spec.perm, dtype=torch.long)
    inv = torch.as_tensor(spec.inv_perm, dtype=torch.long)
    permute_tokens(xt, perm, inv).backward(_t(dy))
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    # the backward is the gather by inv_perm, not a scatter
    node = permute_tokens(xt, perm, inv).grad_fn
    assert type(node).__name__ == "_PermuteTokensBackward"


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layer_norm_backward_matches_jax(dtype):
    """The port's LayerNorm against the JAX ``_ln_fn`` custom VJP: output and the
    gradients of x, scale and bias (f32: 5e-6 normalized; bf16: x's gradient rounded
    once, relative L2 <= 2e-3)."""
    from heal_swin_tpu.models.layers import _ln_fn

    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(6, 7, 24)) * 3 + 1).astype(np.float32)
    sc = (1 + 0.3 * rng.normal(size=24)).astype(np.float32)
    bi = (0.2 * rng.normal(size=24)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    y, vjp = jax.vjp(lambda a, s, b: _ln_fn(a, s, b, 1e-5).astype(jdt),
                     jnp.asarray(x, jdt), jnp.asarray(sc), jnp.asarray(bi))
    want = vjp(jnp.asarray(dy, jdt))
    ln = LayerNorm(24)
    with torch.no_grad():
        ln.weight.copy_(_t(sc))
        ln.bias.copy_(_t(bi))
    xt = _t(x).to(tdt).requires_grad_()
    out = ln(xt)
    assert out.dtype == tdt
    out.backward(_t(dy).to(tdt))
    _assert_grad(out, y, dtype, "y")
    for name, g, w in zip(["dx", "dscale", "dbias"], [xt.grad, ln.weight.grad, ln.bias.grad],
                          want):
        _assert_grad(g, w, dtype, name)
    assert xt.grad.dtype == tdt and ln.weight.grad.dtype == torch.float32


def test_drop_path_draws_from_its_generator():
    """Two draws from equally seeded generators give the same per-sample masks, other
    seeds other masks; the global RNG is left as it was; training without a generator
    raises."""
    dp = DropPath(0.5).train()
    x = torch.ones(256, 3, 4)
    state = torch.random.get_rng_state()
    a = dp(x, torch.Generator().manual_seed(11))
    b = dp(x, torch.Generator().manual_seed(11))
    c = dp(x, torch.Generator().manual_seed(12))
    assert torch.equal(torch.random.get_rng_state(), state)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        dp(x)
    assert torch.equal(dp.eval()(x), x)
