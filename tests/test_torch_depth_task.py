"""The port's HEAL-SWIN-UNet depth task against the JAX package on the CPU, in float32,
at the NSIDE 8 model of ``test_torch_swin_hp.py`` widened to embed 16 (the fused
depth tail's gate, ``supported_depth``, opens there in the port as in the JAX
package).  The data config is the paper depth run's: no transform,
``standardize``, background masked.

- ``loss_fn`` and every parameter gradient against ``jax.value_and_grad`` of the JAX
  task's ``loss_fn``, on the fused route (the Pallas depth kernel in interpret mode,
  ``HEAL_SWIN_FH_INTERPRET=1``) and the unfused one, for l2 at F = 1 and the NLL at
  F = 2.  Tolerance: loss rtol 1e-5; each gradient, normalized by its largest entry,
  within 1e-4 (the same f32 math in another order through the network and its
  backward).  The JAX gradient tree maps onto the port's parameters with
  ``state_dict_from_flax``.
- ``predict`` in metric depths, a padded-sample mask, ``set_epoch``, the metric
  state, and a 3-step Adam trajectory (losses rtol 1e-5, parameters within 1e-5 +
  1e-4 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from heal_swin_torch.convert import state_dict_from_flax
from heal_swin_torch.models import swin_hp as tsh
from heal_swin_torch.models import tasks as ttasks
from heal_swin_torch.training import optimizer as topt
from heal_swin_torch.training.trainer import step_generator, train_step
from heal_swin_tpu.data.data_config import WoodscapeDepthCommonConfig, WoodscapeHPDepthConfig
from heal_swin_tpu.data.data_spec import DepthDataSpec
from heal_swin_tpu.models import swin_hp as jsh
from heal_swin_tpu.models import tasks as jtasks
from heal_swin_tpu.training import optimizer as jopt

NSIDE = 8
NPIX = 8 * NSIDE * NSIDE
SPEC = DepthDataSpec(dim_in=NPIX, f_in=3, f_out=1, base_pix=8)
DATA = WoodscapeHPDepthConfig(common_depth=WoodscapeDepthCommonConfig(
    mask_background=True, data_transform=None, normalize_data="standardize"))
GRAD_TOL = 1e-4
CASES = [("l2", False), ("l2", True)]  # (loss, use_logvar): the NLL at F = 2


def _cfg_kwargs(fused):
    return dict(
        patch_size=4, window_size=16, shift_size=8, shift_strategy="ring_shift",
        rel_pos_bias="flat", embed_dim=16, depths=[2, 1], num_heads=[2, 2],
        use_cos_attn=True, use_v2_norm_placement=True, patch_embed_norm_layer="LayerNorm",
        drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0, fused_final_head=fused,
    )


def _batch(seed, jtask):
    """Images and network-space targets: metric depths in [0.1, 60] with 35% of the
    pixels background (inf), through the JAX task's transform and normalization."""
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(2, NPIX, 3)).astype(np.float32)
    depth = rng.uniform(0.1, 60.0, size=(2, NPIX)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.35] = np.inf
    return imgs, np.asarray(jtask._to_network(jnp.asarray(depth)))


def _tasks(fused, loss="l2", use_logvar=False, opt_cfg=None):
    """The JAX task with noised parameters, and the port's task holding the same."""
    kw = _cfg_kwargs(fused)
    cd = dict(loss=loss, use_logvar=use_logvar)
    jopt_kw = {} if opt_cfg is None else dict(optimizer_config=jopt.OptimizerConfig(**opt_cfg))
    topt_kw = {} if opt_cfg is None else dict(optimizer_config=topt.OptimizerConfig(**opt_cfg))
    jtask = jtasks.WoodscapeDepthSwinHP(
        jtasks.WoodscapeDepthSwinHPConfig(
            swin_hp_transformer_config=jsh.SwinHPTransformerConfig(**kw),
            common_depth_config=jtasks.CommonDepthConfig(**cd), **jopt_kw), SPEC, DATA)
    params = jtask.init_variables(jax.random.PRNGKey(0), np.zeros((1, NPIX, 3), np.float32))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)
    ttask = ttasks.WoodscapeDepthSwinHP(
        ttasks.WoodscapeDepthSwinHPConfig(
            tsh.SwinHPTransformerConfig(**kw),
            common_depth_config=ttasks.CommonDepthConfig(**cd), **topt_kw), SPEC, DATA,
        device="cpu")
    ttask.model.load_state_dict(state_dict_from_flax(params), strict=True)
    return jtask, params, ttask


def _assert_grads_match(ttask, grads_jax):
    want = state_dict_from_flax(jax.tree.map(np.asarray, grads_jax))
    params = dict(ttask.model.named_parameters())
    assert set(want) == set(params)
    for name, p in params.items():
        g, w = p.grad.numpy(), want[name].numpy()
        scale = max(np.abs(w).max(), 1e-8)
        np.testing.assert_allclose(g / scale, w / scale, atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("loss,use_logvar", CASES, ids=["l2", "nll"])
def test_loss_and_gradients_match_jax(fused, loss, use_logvar, monkeypatch):
    monkeypatch.setenv("HEAL_SWIN_FH_INTERPRET", "1")
    jtask, params, ttask = _tasks(fused, loss, use_logvar)
    assert ttask._fused_tail_ok() == jtask._fused_tail_ok() == fused
    assert ttask._loss_kind() == jtask._loss_kind()
    imgs, targets = _batch(2, jtask)

    def jloss(p):
        return jtask.loss_fn(p, jnp.asarray(imgs), jnp.asarray(targets))

    (loss_j, out_j), grads_j = jax.value_and_grad(jloss, has_aux=True)(params)
    loss_t, out_t = ttask.loss_fn(torch.from_numpy(imgs), torch.from_numpy(targets))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert tuple(out_t.shape) == tuple(out_j.shape) == (2, NPIX, 2 if use_logvar else 1)
    assert not out_t.requires_grad or not fused  # the fused predictions: a metrics tap
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-5)
    _assert_grads_match(ttask, grads_j)


@pytest.mark.parametrize("use_logvar", [False, True])
def test_predict_matches_jax(use_logvar):
    """Metric depths on channel 0 (un-normalized), a logvar channel in network space."""
    jtask, params, ttask = _tasks(True, use_logvar=use_logvar)
    imgs, _ = _batch(3, jtask)
    want = np.asarray(jtask.predict(params, jnp.asarray(imgs)))
    got = ttask.predict(None, torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    # channel 0 is metric: the network's output, un-normalized with the masked stats
    net = ttask.model(torch.from_numpy(imgs))
    np.testing.assert_allclose(got[..., 0].numpy(),
                               (net[..., 0] * 29.58008801108711 + 13.654291032986958).detach()
                               .numpy(), rtol=1e-6)
    if use_logvar:
        np.testing.assert_array_equal(got[..., 1].numpy(), net[..., 1].detach().numpy())


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_sample_mask_matches_jax(fused, monkeypatch):
    """A padded sample's targets become inf: the loss covers the other sample only."""
    monkeypatch.setenv("HEAL_SWIN_FH_INTERPRET", "1")
    jtask, params, ttask = _tasks(fused)
    imgs, targets = _batch(4, jtask)
    mask = np.asarray([True, False])
    loss_j, _ = jtask.loss_fn(params, jnp.asarray(imgs), jnp.asarray(targets),
                              sample_mask=jnp.asarray(mask))
    with torch.no_grad():
        loss_t, _ = ttask.loss_fn(torch.from_numpy(imgs), torch.from_numpy(targets),
                                  sample_mask=torch.from_numpy(mask))
        only, _ = ttask.loss_fn(torch.from_numpy(imgs[:1]), torch.from_numpy(targets[:1]))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(loss_t), float(only), rtol=1e-5)
    st = ttask.metric_update(ttask.metric_init(), torch.from_numpy(
        np.zeros((2, NPIX, 1), np.float32)), torch.from_numpy(targets), torch.from_numpy(mask))
    assert float(st["count"]) == float(np.isfinite(targets[0]).sum())


def test_set_epoch_matches_jax():
    """use_logvar runs the NLL from the start, so set_epoch never switches it; a task
    whose loss was set to l2 switches to the NLL at train_uncertainty_after."""
    for use_logvar in (False, True):
        jtask, _, ttask = _tasks(True, use_logvar=use_logvar)
        for task in (jtask, ttask):
            task.cd = dataclasses.replace(task.cd, train_uncertainty_after=2)
        assert ttask._loss_kind() == jtask._loss_kind() == (("nll" if use_logvar else "l2"),
                                                            1.0)
        assert [ttask.set_epoch(e) for e in range(4)] == [jtask.set_epoch(e) for e in range(4)]
        assert ttask._loss_kind() == jtask._loss_kind()
    jtask.loss_impl = jtasks.get_depth_loss(jtasks.CommonDepthConfig(loss="l2"))
    ttask.loss_impl = ttasks.L.get_depth_loss(ttasks.CommonDepthConfig(loss="l2"))
    assert [ttask.set_epoch(e) for e in range(4)] == [jtask.set_epoch(e) for e in range(4)] \
        == [False, False, True, False]
    assert ttask._loss_kind()[0] == jtask._loss_kind()[0] == "nll"
    assert ttask._epoch == jtask._epoch == 3


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_adam_trajectory_matches_jax(fused, monkeypatch):
    """Three Adam steps (torch-style weight decay) from the same weights on the same
    batches, through the port's train_step: losses, final parameters, and the metric
    state's count (valid pixels times steps)."""
    monkeypatch.setenv("HEAL_SWIN_FH_INTERPRET", "1")
    cfg = dict(optimizer_name="Adam", learning_rate=1e-3, weight_decay=1e-4)
    jtask, params, ttask = _tasks(fused, opt_cfg=cfg)
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**cfg))
    opt_state = tx.init(params)
    opt = topt.make_optimizer(ttask.model.parameters(), ttask.optimizer_config)
    mstate = ttask.metric_init()
    losses_j, losses_t, valid = [], [], 0
    for step in range(3):
        imgs, targets = _batch(10 + step, jtask)

        def jloss(p):
            return jtask.loss_fn(p, jnp.asarray(imgs), jnp.asarray(targets))[0]

        loss_j, grads = jax.value_and_grad(jloss)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses_j.append(float(loss_j))
        loss_t, mstate = train_step(ttask, opt, mstate, torch.from_numpy(imgs),
                                    torch.from_numpy(targets), step_generator(0, step, "cpu"))
        losses_t.append(float(loss_t))
        valid += int(np.isfinite(targets).sum())
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    want = state_dict_from_flax(jax.tree.map(np.asarray, params))
    for name, p in ttask.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert float(mstate["count"]) == valid


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("loss,use_logvar", CASES, ids=["l2", "nll"])
def test_metric_state_matches_jax(fused, loss, use_logvar, monkeypatch):
    """metric_update (in metric space) and metric_compute against the JAX task's, with
    the mean std of a logvar channel: on the JAX task's own outputs every state entry
    within rtol 1e-5; on the port's outputs the same count and the same squared and
    absolute errors within rtol 1e-4.  (iRMSE inverts metric depths, and a random
    network predicts some near 0, where the f32 difference of the two outputs moves it
    by far more than the outputs move.)"""
    monkeypatch.setenv("HEAL_SWIN_FH_INTERPRET", "1")
    jtask, params, ttask = _tasks(fused, loss, use_logvar)
    imgs, targets = _batch(5, jtask)
    _, out_j = jtask.loss_fn(params, jnp.asarray(imgs), jnp.asarray(targets))
    with torch.no_grad():
        _, out_t = ttask.loss_fn(torch.from_numpy(imgs), torch.from_numpy(targets))
    sj = jtask.metric_update(jtask.metric_init(), out_j, jnp.asarray(targets))
    st = ttask.metric_update(ttask.metric_init(), torch.from_numpy(np.asarray(out_j)),
                             torch.from_numpy(targets))
    for k in sj:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), rtol=1e-5, err_msg=k)
    own = ttask.metric_update(ttask.metric_init(), out_t, torch.from_numpy(targets))
    assert float(own["count"]) == float(sj["count"]) == float(np.isfinite(targets).sum())
    for k in ("sq_err", "abs_err", "sq_rel_ref"):
        np.testing.assert_allclose(own[k].numpy(), np.asarray(sj[k]), rtol=1e-4, err_msg=k)
    want = jtask.metric_compute(sj, "train_")
    got = ttask.metric_compute(st, "train_")
    assert list(got) == list(want)
    assert ("train_mean_std" in got) == use_logvar
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], rtol=1e-4)


@pytest.mark.parametrize("f_out", [1, 2])
def test_depth_model_converts(f_out):
    """state_dict_from_flax maps the depth model's tree, head (f_out, embed, 1)."""
    kw = _cfg_kwargs(True)
    spec = SPEC.replace(f_out=f_out)
    jmodel = jsh.SwinHPTransformerSys(jsh.SwinHPTransformerConfig(**kw), spec)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, NPIX, 3)), True)
    sd = state_dict_from_flax(params)
    port = tsh.SwinHPTransformerSys(tsh.SwinHPTransformerConfig(**kw), spec, device="cpu")
    assert set(port.state_dict()) == set(sd)
    assert tuple(sd["decoder.output.weight"].shape) == (f_out, 16, 1)
    port.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(sd["decoder.output.weight"][:, :, 0].numpy(),
                                  np.asarray(params["params"]["decoder"]["output"]["kernel"]).T)


def test_config_fields_match_jax():
    """One task config drives both packages: the same fields and defaults."""
    for name in ("WoodscapeDepthSwinHPConfig", "CommonDepthConfig"):
        jf = [f.name for f in dataclasses.fields(getattr(jtasks, name))]
        tf = [f.name for f in dataclasses.fields(getattr(ttasks, name))]
        assert jf == tf, name
    assert dataclasses.asdict(jtasks.CommonDepthConfig()) == dataclasses.asdict(
        ttasks.CommonDepthConfig())
    assert ttasks.WoodscapeDepthSwinHP.NAME == jtasks.WoodscapeDepthSwinHP.NAME
    assert ttasks.WoodscapeDepthSwinHP.input_key == jtasks.WoodscapeDepthSwinHP.input_key
