"""The port's flat SWIN-UNet tasks against the JAX package on the CPU, in float32, at the
32 x 64 model of ``test_torch_swin_flat.py`` (two stages, embed 32, window 8 x 8, patch
2: the tail has p = 4 sub-pixels a token and C 32, which the fused tail takes).

- ``WoodscapeSegmenterSwin.loss_fn`` and every parameter gradient against
  ``jax.value_and_grad`` of the JAX task's, on the fused tail (the Pallas kernel in
  interpret mode, ``HEAL_SWIN_FH_INTERPRET=1``, fed through the depth-to-space
  rearrangement of the targets) and the unfused one; ``predict``'s classes through the
  fused predict tail and the unfused argmax.
- ``WoodscapeDepthSwin``: loss and gradients (always the unfused tail, as the JAX gate
  gives the flat model), ``predict`` in metric depths, a padded-sample mask.
- A 3-step Adam trajectory of each task.

Tolerances: loss rtol 1e-5; each gradient, normalized by its largest entry, within 1e-5,
a logit scale's within 5e-5 (one sum over every window and token of its stage, whose
terms cancel: measured 1.9e-5 on the depth task); parameters after 3 Adam steps within
1e-5 + 1e-4 relative, except at most 0.1% of a tensor's entries, each within 3 steps of
the learning rate (Adam's step is m / sqrt(nu): an entry whose gradients are near zero
turns the f32 rounding of its gradient into a step of up to the learning rate; measured
one entry of 4096 off by 2.7e-5 on the depth task).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from heal_swin_torch.convert import state_dict_from_flax
from heal_swin_torch.models import swin_flat as tsf
from heal_swin_torch.models import tasks as ttasks
from heal_swin_torch.training import optimizer as topt
from heal_swin_torch.training.trainer import step_generator, train_step
from heal_swin_tpu.data.data_config import WoodscapeDepthCommonConfig, WoodscapeDepthFlatConfig
from heal_swin_tpu.data.data_spec import DataSpec, DepthDataSpec
from heal_swin_tpu.models import swin_flat as jsf
from heal_swin_tpu.models import tasks as jtasks
from heal_swin_tpu.training import optimizer as jopt

H, W = 32, 64
F_OUT = 5
SPEC = DataSpec(dim_in=(H, W), f_in=3, f_out=F_OUT)
DEPTH_SPEC = DepthDataSpec(dim_in=(H, W), f_in=3, f_out=1)
DATA = WoodscapeDepthFlatConfig(common_depth=WoodscapeDepthCommonConfig(
    mask_background=True, data_transform=None, normalize_data="standardize"))
CLASS_WEIGHTS = [0.5 + 0.25 * i for i in range(F_OUT)]
GRAD_TOL = 1e-5
LOGIT_SCALE_GRAD_TOL = 5e-5
OPT = dict(optimizer_name="Adam", learning_rate=1e-3, weight_decay=1e-4)


def cfg_kwargs(fused=True, v2=True, cos=True):
    return dict(patch_size=2, window_size=8, shift_size=4, embed_dim=32, depths=[2, 2],
                num_heads=[1, 2], use_cos_attn=cos, use_v2_norm_placement=v2,
                patch_embed_norm_layer="LayerNorm", drop_rate=0.0, attn_drop_rate=0.0,
                drop_path_rate=0.0, fused_final_head=fused)


def noised(params, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)


def seg_tasks(kw, opt=None):
    jopt_kw = {} if opt is None else dict(optimizer_config=jopt.OptimizerConfig(**opt))
    topt_kw = {} if opt is None else dict(optimizer_config=topt.OptimizerConfig(**opt))
    jtask = jtasks.WoodscapeSegmenterSwin(jtasks.WoodscapeSegmenterSwinConfig(
        swin_transformer_config=jsf.SwinTransformerConfig(**kw),
        class_weights=CLASS_WEIGHTS, **jopt_kw), SPEC)
    params = noised(jtask.init_variables(jax.random.PRNGKey(0), np.zeros((1, H, W, 3),
                                                                         np.float32)))
    ttask = ttasks.WoodscapeSegmenterSwin(ttasks.WoodscapeSegmenterSwinConfig(
        tsf.SwinTransformerConfig(**kw), class_weights=CLASS_WEIGHTS, **topt_kw), SPEC,
        device="cpu")
    ttask.model.load_state_dict(state_dict_from_flax(params), strict=True)
    return jtask, params, ttask


def depth_tasks(kw, use_logvar=False, opt=None):
    cd = dict(loss="l2", use_logvar=use_logvar)
    jopt_kw = {} if opt is None else dict(optimizer_config=jopt.OptimizerConfig(**opt))
    topt_kw = {} if opt is None else dict(optimizer_config=topt.OptimizerConfig(**opt))
    jtask = jtasks.WoodscapeDepthSwin(jtasks.WoodscapeDepthSwinConfig(
        swin_transformer_config=jsf.SwinTransformerConfig(**kw),
        common_depth_config=jtasks.CommonDepthConfig(**cd), **jopt_kw), DEPTH_SPEC, DATA)
    params = noised(jtask.init_variables(jax.random.PRNGKey(0), np.zeros((1, H, W, 3),
                                                                         np.float32)))
    ttask = ttasks.WoodscapeDepthSwin(ttasks.WoodscapeDepthSwinConfig(
        tsf.SwinTransformerConfig(**kw), common_depth_config=ttasks.CommonDepthConfig(**cd),
        **topt_kw), DEPTH_SPEC, DATA, device="cpu")
    ttask.model.load_state_dict(state_dict_from_flax(params), strict=True)
    return jtask, params, ttask


def seg_batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, H, W, 3)).astype(np.float32),
            rng.integers(0, F_OUT, (2, H, W)).astype(np.int32))


def depth_batch(seed, jtask):
    """Network-space targets: metric depths in [0.1, 60], 35% background (inf)."""
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    depth = rng.uniform(0.1, 60.0, size=(2, H, W)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.35] = np.inf
    return imgs, np.asarray(jtask._to_network(jnp.asarray(depth)))


def assert_grads_match(ttask, grads_jax):
    want = state_dict_from_flax(jax.tree.map(np.asarray, grads_jax))
    params = dict(ttask.model.named_parameters())
    assert set(want) == set(params)
    for name, p in params.items():
        g, w = p.grad.numpy(), want[name].numpy()
        scale = max(np.abs(w).max(), 1e-8)
        tol = LOGIT_SCALE_GRAD_TOL if name.endswith("logit_scale") else GRAD_TOL
        np.testing.assert_allclose(g / scale, w / scale, atol=tol, err_msg=name)


def assert_params_match(ttask, params, lr, steps):
    want = state_dict_from_flax(jax.tree.map(np.asarray, params))
    for name, p in ttask.model.named_parameters():
        got, w = p.detach().numpy(), want[name].numpy()
        off = np.abs(got - w) > 1e-5 + 1e-4 * np.abs(w)
        assert off.mean() <= 1e-3, (name, int(off.sum()))
        np.testing.assert_allclose(got, w, atol=steps * lr, err_msg=name)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("v2,cos", [(True, True), (False, False)], ids=["cos_v2", "dot_v1"])
def test_seg_loss_and_gradients_match_jax(fused, v2, cos, monkeypatch):
    monkeypatch.setenv("HEAL_SWIN_FH_INTERPRET", "1")
    jtask, params, ttask = seg_tasks(cfg_kwargs(fused, v2, cos))
    assert jtask._fused_tail_ok(None) == fused
    imgs, targets = seg_batch(2)

    def jloss(p):
        return jtask.loss_fn(p, jnp.asarray(imgs), jnp.asarray(targets))

    (loss_j, out_j), grads_j = jax.value_and_grad(jloss, has_aux=True)(params)
    loss_t, out_t = ttask.loss_fn(torch.from_numpy(imgs), torch.from_numpy(targets))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert tuple(out_t.shape) == tuple(out_j.shape)
    if fused:  # the step's confusion matrix, from the kernel on both sides
        assert tuple(out_t.shape) == (F_OUT, F_OUT)
        np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    assert_grads_match(ttask, grads_j)
    # the metric state the step's outputs give, as the JAX task's
    sj = jtask.metric_update(jtask.metric_init(), out_j, jnp.asarray(targets))
    st = ttask.metric_update(ttask.metric_init(), out_t.detach(), torch.from_numpy(targets))
    for k in sj:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), err_msg=k)


def test_kernel_layout_round_trips():
    """The targets' depth-to-space rearrangement into the tail kernels' (B*T, p1*p2)
    rows and its inverse: the JAX task's layout, and the identity composed."""
    jtask, _, ttask = seg_tasks(cfg_kwargs())
    _, targets = seg_batch(5)
    rows = ttask._kernel_targets(ttask.model, torch.from_numpy(targets))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jtask._kernel_targets(targets)))
    back = ttask._pred_from_kernel(ttask.model, rows, 2)
    np.testing.assert_array_equal(back.numpy(), targets)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_seg_predict_matches_jax(fused, monkeypatch):
    """The port's classes (the plain K3 on the CPU, or the argmax of the unfused tail)
    against the JAX task's predict (the Pallas predict kernel in interpret mode): equal
    except at near-ties (top-2 JAX logits within 1e-5)."""
    monkeypatch.setenv("HEAL_SWIN_FH_INTERPRET", "1")
    jtask, params, ttask = seg_tasks(cfg_kwargs(fused))
    imgs, _ = seg_batch(3)
    preds_j = np.asarray(jtask.predict(params, jnp.asarray(imgs)))
    logits_j = np.asarray(jtask.model.apply(params, jnp.asarray(imgs), True))
    preds_t = ttask.predict(None, torch.from_numpy(imgs))
    assert preds_t.shape == (2, H, W) and preds_t.dtype == torch.int32
    top2 = np.sort(logits_j, axis=-1)[..., -2:]
    ok = (top2[..., 1] - top2[..., 0]) >= 1e-5
    assert ok.mean() > 0.99
    np.testing.assert_array_equal(preds_t.numpy()[ok], preds_j[ok])


@pytest.mark.parametrize("use_logvar", [False, True], ids=["l2", "nll"])
def test_depth_loss_gradients_and_predict_match_jax(use_logvar, monkeypatch):
    """The depth loss and every gradient (unfused tail on both sides: the JAX gate reads
    only the HP config), predict in metric depths, and a padded-sample mask."""
    monkeypatch.setenv("HEAL_SWIN_FH_INTERPRET", "1")
    jtask, params, ttask = depth_tasks(cfg_kwargs(), use_logvar)
    assert jtask._fused_tail_ok() is False and ttask._fused_tail_ok() is False
    imgs, targets = depth_batch(2, jtask)

    def jloss(p):
        return jtask.loss_fn(p, jnp.asarray(imgs), jnp.asarray(targets))

    (loss_j, out_j), grads_j = jax.value_and_grad(jloss, has_aux=True)(params)
    loss_t, out_t = ttask.loss_fn(torch.from_numpy(imgs), torch.from_numpy(targets))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert tuple(out_t.shape) == tuple(out_j.shape) == (2, H, W, 2 if use_logvar else 1)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=1e-5)
    assert_grads_match(ttask, grads_j)

    want = np.asarray(jtask.predict(params, jnp.asarray(imgs)))
    got = ttask.predict(None, torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)

    mask = np.array([True, False])
    lj, _ = jtask.loss_fn(params, jnp.asarray(imgs), jnp.asarray(targets),
                          sample_mask=jnp.asarray(mask))
    with torch.no_grad():
        lt, _ = ttask.loss_fn(torch.from_numpy(imgs), torch.from_numpy(targets),
                              sample_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    with torch.no_grad():
        l0, _ = ttask.loss_fn(torch.from_numpy(imgs[:1]), torch.from_numpy(targets[:1]))
    np.testing.assert_allclose(float(lt), float(l0), rtol=1e-6)


@pytest.mark.parametrize("task", ["swin", "depth_swin"])
def test_adam_trajectory_matches_jax(task, monkeypatch):
    """Three Adam steps (torch-style weight decay) from the same weights on the same
    batches: losses and final parameters (segmentation on the fused tail)."""
    monkeypatch.setenv("HEAL_SWIN_FH_INTERPRET", "1")
    if task == "swin":
        jtask, params, ttask = seg_tasks(cfg_kwargs(), OPT)
    else:
        jtask, params, ttask = depth_tasks(cfg_kwargs(), opt=OPT)
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**OPT))
    opt_state = tx.init(params)
    opt = topt.make_optimizer(ttask.model.parameters(), ttask.optimizer_config)
    mstate = ttask.metric_init()
    losses_j, losses_t = [], []
    for step in range(3):
        imgs, targets = seg_batch(10 + step) if task == "swin" else depth_batch(10 + step, jtask)

        def jloss(p):
            return jtask.loss_fn(p, jnp.asarray(imgs), jnp.asarray(targets))[0]

        loss_j, grads = jax.value_and_grad(jloss)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses_j.append(float(loss_j))
        loss_t, mstate = train_step(ttask, opt, mstate, torch.from_numpy(imgs),
                                    torch.from_numpy(targets), step_generator(0, step, "cpu"))
        losses_t.append(float(loss_t))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert_params_match(ttask, params, OPT["learning_rate"], 3)


def test_registry_and_build_task():
    """The JAX registry's names, and the run entry's ``build_task`` on each flat
    config (the depth task with its data config)."""
    from heal_swin_torch.train import build_task

    assert list(ttasks.MODELS) == list(jtasks.MODELS)
    assert ttasks.MODEL_NAME_FROM_CONFIG_NAME == jtasks.MODEL_NAME_FROM_CONFIG_NAME
    kw = cfg_kwargs()
    seg = build_task(ttasks.WoodscapeSegmenterSwinConfig(tsf.SwinTransformerConfig(**kw)),
                     SPEC, None, device="cpu")
    assert type(seg) is ttasks.WoodscapeSegmenterSwin and seg.input_key == "s2_imgs"
    depth = build_task(ttasks.WoodscapeDepthSwinConfig(tsf.SwinTransformerConfig(**kw)),
                       DEPTH_SPEC, DATA, device="cpu")
    assert type(depth) is ttasks.WoodscapeDepthSwin and depth.dc is DATA.common_depth


@pytest.mark.parametrize("name,path", [
    ("swin_synwoodscape_large_train_run_config",
     "run_configs/segmentation/swin_synwoodscape_large_train_run_config.py"),
    ("depth_swin_train_run_config", "run_configs/depth_estimation/depth_swin_train_run_config.py"),
])
def test_paper_flat_configs_match_jax(name, path, monkeypatch):
    """The port's copies of the two paper flat run configs give the JAX configs' run and
    PL configs, field for field."""
    import dataclasses as dc
    from pathlib import Path

    from heal_swin_torch.utils.utils import get_config_from_config_path as tget
    from heal_swin_tpu.utils.utils import get_config_from_config_path as jget
    from tests.test_torch_trainer import to_port

    monkeypatch.setenv("SLURM_JOB_ID", "flat_test")
    repo = Path(__file__).resolve().parents[1]
    port = repo / "heal_swin_torch" / "configs" / f"{name}.py"
    for fn in ("get_train_run_config", "get_pl_config"):
        got, want = tget(port, fn), jget(repo / path, fn)
        assert dc.asdict(got) == dc.asdict(to_port(want)), fn
