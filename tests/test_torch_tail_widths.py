"""The decoder tail at every width the Pallas tails take, on the CPU: the port's plain
K3, K6/K7 and K8/K9 against ``fused_final_head_predict``, ``fused_final_head`` and
``fused_final_head_depth`` run in interpret mode (and their ``jax.vjp``), the port's fused
route gates against the JAX package's ``supported`` and ``supported_depth``, and a small
HEAL-SWIN segmentation task at 25 classes and embed 40 against the JAX task through the
fused Pallas tail.

On the card these shapes run on the wide route (``csrc/final_head_wide.cu``: the expand by
the hand-written GEMMs, one row kernel over the T p sub-rows, the backward's products) or,
at C 32-128, on the row cores with the head in chunks and the slices streamed; the plain
versions held here are those of both.  Cases: (C, F, p) in (8, 3, 1), (40, 25, 4), (136,
128, 4), (192, 33, 16), (192, 128, 4), the paths' (128, 10, 4) and (96, 25, 4), and the
chunk edges (96, 32, 4), (96, 33, 4), (64, 64, 1), (32, 128, 16) for K3, K6 and K7; the
depth heads F 1 and 2 at C 40 and 136 for every loss kind; T 256; f32 and bf16.  Limits
as the existing tail tests state them:

- float32: the loss rtol 1e-5, the confusion matrix equal, every gradient normalized by
  its largest entry within 5e-6 (``test_torch_tail_f32.py``); the depth loss rtol 1e-6
  (``test_torch_depth_kernels.py``) and the depth predictions, normalized by the largest,
  within 5e-6 as the gradients (a logit sums up to 136 terms here against 32 there, so an
  absolute limit of 1e-6 near zero would read the summation order).
- bfloat16: the loss rtol 3e-5, every gradient and the depth predictions within
  relative L2 2e-3 (``test_torch_train_kernels.py``, ``test_torch_depth_kernels.py``);
  the confusion matrix and the classes equal outside near-ties.
- K3's classes equal outside near-ties (the plain top-2 logits within 1e-5, f32 sums in
  another order; ``test_torch_final_head.py``).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch.convert import state_dict_from_flax
from heal_swin_torch.models import swin_hp as tsh
from heal_swin_torch.models import tasks as ttasks
from heal_swin_torch.ops import final_head as fh
from heal_swin_tpu.data.data_spec import DataSpec
from heal_swin_tpu.models import swin_hp as jsh
from heal_swin_tpu.models import tasks as jtasks
from heal_swin_tpu.ops import final_head as jfh

T = 256
F32_TOL = 5e-6
LOSS_RTOL = 1e-5
BF16_REL_L2 = 2e-3
BF16_LOSS_RTOL = 3e-5
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# corners of the Pallas tails' domain, the two paths' tails (C 128, F 10, p 4 and C 96, F
# 25, p 4), and the row cores' chunk edges (32 and 33 classes at C 96; 64 at C 64, p 1;
# 128 at C 32, p 16)
SEG_CASES = [(8, 3, 1), (40, 25, 4), (136, 128, 4), (192, 33, 16), (192, 128, 4),
             (128, 10, 4), (96, 25, 4), (96, 32, 4), (96, 33, 4), (64, 64, 1), (32, 128, 16)]
DEPTH_KINDS = [("l2", 1, 1.0), ("l1", 1, 1.0), ("huber", 1, 0.7), ("nll", 2, 1.0),
               ("l2", 2, 1.0)]
GRAD_NAMES = ["dx", "dwe", "dgamma", "dbeta", "dwh"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _operands(seed, C, F, p):
    """x, We (the expand keeps the tokens' scale), gamma, beta, Wh, targets, weights."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(T, C)).astype(f),
            (rng.normal(size=(C, p * C)) / np.sqrt(C)).astype(f),
            (1.0 + 0.3 * rng.normal(size=C)).astype(f), (0.2 * rng.normal(size=C)).astype(f),
            (rng.normal(size=(C, F)) * 0.3).astype(f),
            rng.integers(0, F, (T, p)).astype(np.int32),
            rng.uniform(0.5, 2.0, (T, p)).astype(f))


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


def _near_ties(logits, gap=1e-5):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) < gap


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("C,F,p", SEG_CASES, ids=[f"C{c}-F{f}-p{p}" for c, f, p in SEG_CASES])
def test_segmentation_tail_plain_matches_pallas(C, F, p, dtype):
    """K3's plain version (classes), K6's (loss, confusion matrix) and K7's (every
    gradient, for a loss gradient of 1.3) against the Pallas kernels and their VJP."""
    jdt, tdt = DTYPES[dtype]
    x, we, g, b, wh, y, w = _operands(C + F + p, C, F, p)
    jx = jnp.asarray(x, jdt)

    def fn(x, we, g, b, wh):
        return jfh.fused_final_head(x, we, g, b, wh, jnp.asarray(y), jnp.asarray(w),
                                    patch_size=p, interpret=True)

    (loss, cm), vjp = jax.vjp(fn, jx, *(jnp.asarray(a) for a in (we, g, b, wh)))
    want = vjp((jnp.asarray(1.3, jnp.float32), jnp.zeros_like(cm)))
    classes = np.asarray(jfh.fused_final_head_predict(
        jx, jnp.asarray(we, jdt), jnp.asarray(g), jnp.asarray(b), jnp.asarray(wh, jdt),
        patch_size=p, interpret=True))

    ops = (_t(x).to(tdt), _t(we), _t(g), _t(b), _t(wh))
    logits = fh.final_head_logits_plain(*ops, patch_size=p)
    got = fh.final_head_predict_plain(*ops, patch_size=p).numpy()
    far = ~_near_ties(logits.numpy())
    np.testing.assert_array_equal(got[far], classes[far])
    assert far.mean() > 0.95

    num, den, tcm = fh.final_head_loss_plain(*ops, _t(y), _t(w), patch_size=p)
    np.testing.assert_allclose(float(num / den), float(loss),
                               rtol=LOSS_RTOL if dtype == "float32" else BF16_LOSS_RTOL)
    if dtype == "float32":
        np.testing.assert_array_equal(tcm.numpy(), np.asarray(cm))
    else:  # rows of the rounded logits at a near-tie may count in another column
        lr = logits.to(torch.bfloat16).float().numpy()
        top2 = np.sort(lr, axis=-1)[..., -2:]
        near = (top2[..., 1] - top2[..., 0]) <= 2 * 2.0 ** -7 * np.abs(top2[..., 1])
        np.testing.assert_array_equal(tcm.numpy().sum(1), np.asarray(cm).sum(1))
        assert np.abs(tcm.numpy() - np.asarray(cm)).sum() <= 2 * near.sum()
    grads = fh.final_head_loss_bwd_plain(*ops, _t(y), _t(w), torch.tensor(1.3) / den,
                                         patch_size=p)
    for name, gt, wt in zip(GRAD_NAMES, grads, want):
        _assert_grad(gt, wt, dtype, name)


DEPTH_CASES = [(C,) + k for C in (40, 136) for k in DEPTH_KINDS]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("C,kind,F,delta", DEPTH_CASES,
                         ids=[f"C{c}-{k}-F{f}" for c, k, f, _ in DEPTH_CASES])
def test_depth_tail_plain_matches_pallas(C, kind, F, delta, dtype):
    """K8's plain version (loss, predictions) and K9's (every gradient, for a loss
    gradient of 1.7) against ``fused_final_head_depth`` and its VJP, p 4."""
    jdt, tdt = DTYPES[dtype]
    p = 4
    x, we, g, b, wh, _, _ = _operands(C + F, C, F, p)
    rng = np.random.default_rng(C)
    tgt = (1.0 + rng.normal(size=(T, p))).astype(np.float32)  # N(1, 1): no cancelling dbeta
    tgt[rng.uniform(size=(T, p)) < 0.3] = np.inf

    def fn(x, we, g, b, wh):
        return jfh.fused_final_head_depth(x, we, g, b, wh, jnp.asarray(tgt), patch_size=p,
                                          loss_kind=kind, huber_delta=delta, interpret=True)

    (loss_j, preds_j), vjp = jax.vjp(fn, jnp.asarray(x, jdt),
                                     *(jnp.asarray(a) for a in (we, g, b, wh)))
    grads_j = vjp((jnp.asarray(1.7, jnp.float32), jnp.zeros_like(preds_j)))
    args = (_t(x).to(tdt), _t(we), _t(g), _t(b), _t(wh), _t(tgt))
    kw = dict(patch_size=p, loss_kind=kind, huber_delta=delta)
    num, den, preds = fh.final_head_depth_loss_plain(*args, **kw)
    den_s = torch.clamp_min(den, 1.0)
    grads = fh.final_head_depth_loss_bwd_plain(*args, torch.tensor(1.7) / den_s, **kw)
    pj, pt = np.asarray(preds_j.astype(jnp.float32)), preds.float().numpy()
    assert preds.dtype == tdt and pt.shape == pj.shape
    if dtype == "float32":
        np.testing.assert_allclose(float(num / den_s), float(loss_j), rtol=1e-6)
        scale = np.abs(pj).max()  # held as the gradients: C up to 136 terms a logit
        np.testing.assert_allclose(pt / scale, pj / scale, atol=F32_TOL)
    else:
        np.testing.assert_allclose(float(num / den_s), float(loss_j), rtol=BF16_LOSS_RTOL)
        assert _rel_l2(pt, pj) <= BF16_REL_L2
    for name, gt, wt in zip(GRAD_NAMES, grads, grads_j):
        _assert_grad(gt, wt, dtype, name)
    if F == 2 and kind != "nll":
        assert float(grads[4][:, 1].abs().max()) == 0.0


GATE_T = (64, 128, 192, 256, 384, 512, 1000, 196608)
GATE_C = (8, 12, 40, 44, 96, 136, 192, 200, 384)
GATE_F = (1, 2, 3, 25, 128, 129)
GATE_P = (1, 4, 16)
GATE_DTYPES = [(jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32),
               (jnp.float16, torch.float16)]


@pytest.mark.parametrize("jdt,tdt", GATE_DTYPES, ids=["bfloat16", "float32", "float16"])
def test_route_gates_equal_the_jax_gates(jdt, tdt):
    """``supported`` (the segmentation tasks' loss and predict) and ``supported_depth``
    (the depth task) say yes and no exactly where the JAX
    package's ``supported`` and ``supported_depth`` do, over a grid that crosses every
    condition (T % 128, C % 8, F <= 128, F in {1, 2}, the dtype); and where they say yes
    the kernels take the tail up to C 192 (above it a CUDA tensor raises)."""
    seen = set()
    for shape in itertools.product(GATE_T, GATE_C, GATE_F, GATE_P):
        seg, dep = jfh.supported(*shape, jdt), jfh.supported_depth(*shape, jdt)
        assert fh.supported(*shape, tdt) == seg, shape
        assert fh.supported_depth(*shape, tdt) == dep, shape
        Tt, C, F, _ = shape
        if seg:
            assert fh.kernels_take(Tt, C, F, tdt) == (C <= fh.KERNEL_MAX_C), shape
        seen.add((seg, dep))
    assert seen == ({(False, False)} if jdt == jnp.float16 else
                    {(False, False), (True, False), (True, True)})


NSIDE = 8
NPIX = 8 * NSIDE * NSIDE


def _task_kwargs(embed, fused=True, patch=4):
    return dict(patch_size=patch, window_size=16, shift_size=8, shift_strategy="ring_shift",
                rel_pos_bias="flat", embed_dim=embed, depths=[2, 1], num_heads=[2, 4],
                use_cos_attn=True, use_v2_norm_placement=True,
                patch_embed_norm_layer="LayerNorm", drop_rate=0.0, attn_drop_rate=0.0,
                drop_path_rate=0.0, fused_final_head=fused)


def _seg_tasks(embed, classes):
    spec = DataSpec(dim_in=NPIX, f_in=3, f_out=classes, base_pix=8)
    weights = [0.5 + 0.05 * i for i in range(classes)]
    kw = _task_kwargs(embed)
    jtask = jtasks.WoodscapeSegmenterSwinHP(
        jtasks.WoodscapeSegmenterSwinHPConfig(
            swin_hp_transformer_config=jsh.SwinHPTransformerConfig(**kw),
            class_weights=weights), spec)
    ttask = ttasks.WoodscapeSegmenterSwinHP(
        ttasks.WoodscapeSegmenterSwinHPConfig(tsh.SwinHPTransformerConfig(**kw),
                                              class_weights=weights), spec, device="cpu")
    return jtask, ttask


@pytest.mark.parametrize("embed,classes,fused", [(40, 25, True), (36, 25, False)],
                         ids=["embed40-fused", "embed36-unfused"])
def test_task_at_25_classes_matches_jax(embed, classes, fused, monkeypatch):
    """A small HEAL-SWIN segmentation task at SynWoodScape's 25 classes: at embed 40 the
    JAX task's gate takes the fused tail (the Pallas kernel in interpret mode,
    ``HEAL_SWIN_FH_INTERPRET=1``) and so does the port's (the confusion matrix comes
    back); at embed 36 (C % 8 == 4) both run the unfused tail (the logits come back).
    Loss rtol 1e-5 and every parameter gradient, normalized by its largest entry, within
    1e-4 (``test_torch_train_step.py``'s limits), the weights through
    ``state_dict_from_flax``; predict's classes equal outside near-ties of the logits."""
    monkeypatch.setenv("HEAL_SWIN_FH_INTERPRET", "1")
    jtask, ttask = _seg_tasks(embed, classes)
    assert jtask._fused_tail_ok(None) == fused
    assert ttask._fused_tail_ok(ttask.model) == fused
    rng = np.random.default_rng(5)
    imgs = rng.normal(size=(2, NPIX, 3)).astype(np.float32)
    targets = rng.integers(0, classes, (2, NPIX)).astype(np.int32)
    params = jtask.model.init(jax.random.PRNGKey(0), jnp.asarray(imgs), True)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)
    ttask.model.load_state_dict(state_dict_from_flax(params), strict=True)

    def jloss(p):
        return jtask.loss_fn(p, jnp.asarray(imgs), jnp.asarray(targets))

    (loss_j, out_j), grads_j = jax.value_and_grad(jloss, has_aux=True)(params)
    loss_t, out_t = ttask.loss_fn(torch.from_numpy(imgs), torch.from_numpy(targets))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert tuple(out_t.shape) == tuple(out_j.shape)
    assert tuple(out_t.shape) == ((classes, classes) if fused else (2, NPIX, classes))
    if fused:
        np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    want = state_dict_from_flax(jax.tree.map(np.asarray, grads_j))
    for name, prm in ttask.model.named_parameters():
        g, w = prm.grad.numpy(), want[name].numpy()
        scale = max(np.abs(w).max(), 1e-8)
        np.testing.assert_allclose(g / scale, w / scale, atol=1e-4, err_msg=name)

    classes_j = np.asarray(jtask.predict(params, jnp.asarray(imgs)))
    classes_t = ttask.predict(None, torch.from_numpy(imgs)).numpy()
    logits = np.asarray(jtask.model.apply(params, jnp.asarray(imgs), True))
    far = ~_near_ties(logits)
    np.testing.assert_array_equal(classes_t[far], classes_j[far])


def _depth_tasks(embed, use_logvar, loss="l2"):
    from heal_swin_tpu.data.data_spec import DepthDataSpec

    spec = DepthDataSpec(dim_in=NPIX, f_in=3, f_out=1, base_pix=8)
    kw = _task_kwargs(embed)
    cd = dict(loss=loss, use_logvar=use_logvar)
    jtask = jtasks.WoodscapeDepthSwinHP(
        jtasks.WoodscapeDepthSwinHPConfig(
            swin_hp_transformer_config=jsh.SwinHPTransformerConfig(**kw),
            common_depth_config=jtasks.CommonDepthConfig(**cd)), spec)
    ttask = ttasks.WoodscapeDepthSwinHP(
        ttasks.WoodscapeDepthSwinHPConfig(
            tsh.SwinHPTransformerConfig(**kw),
            common_depth_config=ttasks.CommonDepthConfig(**cd)), spec, device="cpu")
    return jtask, ttask


@pytest.mark.parametrize("embed,patch,dtype,fused", [
    (8, 4, None, True), (40, 4, None, True), (40, 4, "bfloat16", True), (200, 4, None, True),
    (36, 4, None, False), (40, 16, None, False), (36, 4, "bfloat16", False)])
def test_task_gates_match_jax(embed, patch, dtype, fused, monkeypatch):
    """The segmentation and depth tasks' route (fused or unfused, ``_fused_tail_ok``)
    equals the JAX tasks' for configs on both sides of the gate: C % 8 (C 200 passes the
    gate, and on the card the kernels refuse it), the tokens of a sample (patch 16 at
    NSIDE 8: 32, not a multiple of 128) and the compute dtype."""
    monkeypatch.setenv("HEAL_SWIN_FH_INTERPRET", "1")
    kw = dict(_task_kwargs(embed, patch=patch), dtype=dtype)
    jcfg, tcfg = jsh.SwinHPTransformerConfig(**kw), tsh.SwinHPTransformerConfig(**kw)
    spec = DataSpec(dim_in=NPIX, f_in=3, f_out=25, base_pix=8)
    jtask = jtasks.WoodscapeSegmenterSwinHP(
        jtasks.WoodscapeSegmenterSwinHPConfig(swin_hp_transformer_config=jcfg), spec)
    assert jtask._fused_tail_ok(None) == fused
    # the port's task built at patch 4 (a network NSIDE 8 admits), its gate read on tcfg
    ttask = ttasks.WoodscapeSegmenterSwinHP(
        ttasks.WoodscapeSegmenterSwinHPConfig(tsh.SwinHPTransformerConfig(**_task_kwargs(8))),
        spec, device="cpu")
    ttask.model.config = tcfg
    assert ttask._fused_tail_ok(ttask.model) == fused
    for use_logvar in (False, True):
        jd, td = _depth_tasks(8, use_logvar)
        jd.config = dataclasses.replace(jd.config, swin_hp_transformer_config=jcfg)
        td.model.config = tcfg
        assert td._fused_tail_ok() == jd._fused_tail_ok() == fused, use_logvar
