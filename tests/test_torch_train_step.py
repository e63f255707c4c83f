"""The port's segmentation train step against the JAX package on the CPU, in float32,
at the NSIDE 8 model of ``test_torch_swin_hp.py``.

- ``loss_fn`` and every parameter gradient against ``jax.value_and_grad`` of the JAX
  task's ``loss_fn`` (the fused decoder tail through the Pallas kernel in interpret
  mode, ``HEAL_SWIN_FH_INTERPRET=1``), on the fused and the unfused route.  The JAX
  gradient tree maps onto the port's parameters with ``state_dict_from_flax``.
  Tolerance: loss rtol 1e-5; each gradient, normalized by its largest entry, within
  1e-4 (the same f32 math in another order through the network and its backward;
  measured <= 3e-6).
- A 3-step Adam trajectory (weight decay 1e-4) against the JAX package's optax chain:
  losses rtol 1e-5, parameters within 1e-5 + 1e-4 relative.
- The metric state the step accumulates, and the train step's use of the DropPath
  generator (reproducible from the seed; the global RNG untouched).
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
from heal_swin_tpu.data.data_spec import DataSpec
from heal_swin_tpu.models import swin_hp as jsh
from heal_swin_tpu.models import tasks as jtasks
from heal_swin_tpu.training import optimizer as jopt

NSIDE = 8
NPIX = 8 * NSIDE * NSIDE
F_OUT = 5
SPEC = DataSpec(dim_in=NPIX, f_in=3, f_out=F_OUT, base_pix=8)
CLASS_WEIGHTS = [0.5 + 0.25 * i for i in range(F_OUT)]
GRAD_TOL = 1e-4


def _cfg_kwargs(fused, strategy="ring_shift", v2=True, cos=True, drop_path_rate=0.0):
    return dict(
        patch_size=4, window_size=16, shift_size=8, shift_strategy=strategy,
        rel_pos_bias="flat", embed_dim=8, depths=[2, 1], num_heads=[2, 2],
        use_cos_attn=cos, use_v2_norm_placement=v2, patch_embed_norm_layer="LayerNorm",
        drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=drop_path_rate,
        fused_final_head=fused,
    )


def _batch(seed):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(2, NPIX, 3)).astype(np.float32)
    targets = rng.integers(0, F_OUT, (2, NPIX)).astype(np.int32)
    return imgs, targets


def _tasks(kw, opt_cfg=None):
    """The JAX task with noised parameters, and the port's task holding the same."""
    opt_kw = {} if opt_cfg is None else dict(optimizer_config=opt_cfg)
    jtask = jtasks.WoodscapeSegmenterSwinHP(
        jtasks.WoodscapeSegmenterSwinHPConfig(
            swin_hp_transformer_config=jsh.SwinHPTransformerConfig(**kw),
            class_weights=CLASS_WEIGHTS), SPEC)
    imgs, _ = _batch(0)
    params = jtask.model.init(jax.random.PRNGKey(0), jnp.asarray(imgs), True)
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)
    ttask = ttasks.WoodscapeSegmenterSwinHP(
        ttasks.WoodscapeSegmenterSwinHPConfig(
            tsh.SwinHPTransformerConfig(**kw), class_weights=CLASS_WEIGHTS, **opt_kw), SPEC)
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
@pytest.mark.parametrize("strategy,v2,cos", [("ring_shift", True, True),
                                             ("nest_grid_shift", False, False)])
def test_loss_and_gradients_match_jax(fused, strategy, v2, cos, monkeypatch):
    monkeypatch.setenv("HEAL_SWIN_FH_INTERPRET", "1")
    kw = _cfg_kwargs(fused, strategy, v2, cos)
    jtask, params, ttask = _tasks(kw)
    imgs, targets = _batch(2)

    def jloss(p):
        return jtask.loss_fn(p, jnp.asarray(imgs), jnp.asarray(targets))

    (loss_j, out_j), grads_j = jax.value_and_grad(jloss, has_aux=True)(params)
    loss_t, out_t = ttask.loss_fn(torch.from_numpy(imgs), torch.from_numpy(targets))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert tuple(out_t.shape) == tuple(out_j.shape)
    if fused:  # the step's confusion matrix; JAX returns it from the kernel too
        np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    _assert_grads_match(ttask, grads_j)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_adam_trajectory_matches_jax(fused, monkeypatch):
    """Three Adam steps (torch-style weight decay) from the same weights on the same
    batches: losses and final parameters."""
    monkeypatch.setenv("HEAL_SWIN_FH_INTERPRET", "1")
    cfg = topt.OptimizerConfig(optimizer_name="Adam", learning_rate=1e-3, weight_decay=1e-4)
    jcfg = jopt.OptimizerConfig(optimizer_name="Adam", learning_rate=1e-3, weight_decay=1e-4)
    jtask, params, ttask = _tasks(_cfg_kwargs(fused), cfg)
    tx = jopt.make_optimizer(jcfg)
    opt_state = tx.init(params)
    opt = topt.make_optimizer(ttask.model.parameters(), ttask.optimizer_config)
    mstate = ttask.metric_init()
    losses_j, losses_t = [], []
    for step in range(3):
        imgs, targets = _batch(10 + step)

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
    want = state_dict_from_flax(jax.tree.map(np.asarray, params))
    for name, p in ttask.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert float(mstate["total"]) == 3 * 2 * NPIX


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_metric_state_matches_jax(fused, monkeypatch):
    """metric_update on the step's outputs (the confusion matrix on the fused route,
    the logits on the unfused) and metric_compute against the JAX task's."""
    monkeypatch.setenv("HEAL_SWIN_FH_INTERPRET", "1")
    jtask, params, ttask = _tasks(_cfg_kwargs(fused))
    imgs, targets = _batch(4)
    _, out_j = jtask.loss_fn(params, jnp.asarray(imgs), jnp.asarray(targets))
    with torch.no_grad():
        _, out_t = ttask.loss_fn(torch.from_numpy(imgs), torch.from_numpy(targets))
    sj = jtask.metric_update(jtask.metric_init(), out_j, jnp.asarray(targets))
    st = ttask.metric_update(ttask.metric_init(), out_t, torch.from_numpy(targets))
    for k in sj:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), err_msg=k)
    want = jtask.metric_compute(sj, "train_", with_per_class=True)
    got = ttask.metric_compute(st, "train_", with_per_class=True)
    assert list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], rtol=1e-6)


def test_train_step_is_reproducible_from_the_seed():
    """With DropPath on, two runs of two steps from the same weights and step seeds
    give the same losses and weights, a third seed another; the global RNG is never
    drawn from."""
    kw = _cfg_kwargs(True, drop_path_rate=0.5)
    imgs, targets = _batch(6)

    def run(seed):
        task = ttasks.WoodscapeSegmenterSwinHP(
            ttasks.WoodscapeSegmenterSwinHPConfig(tsh.SwinHPTransformerConfig(**kw)), SPEC,
            generator=torch.Generator().manual_seed(3))
        opt = topt.make_optimizer(task.model.parameters(), task.optimizer_config)
        mstate = task.metric_init()
        losses = []
        for step in range(2):
            loss, mstate = train_step(task, opt, mstate, torch.from_numpy(imgs),
                                      torch.from_numpy(targets), step_generator(seed, step, "cpu"))
            losses.append(float(loss))
        return losses, task.model.state_dict()

    rng_state = torch.random.get_rng_state()
    (la, sa), (lb, sb), (lc, _) = run(0), run(0), run(1)
    assert torch.equal(torch.random.get_rng_state(), rng_state)
    assert la == lb and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert la[0] != lc[0]


def test_config_fields_match_jax():
    """One task config drives both packages: the same fields, and the optimizer
    config's fields and defaults."""
    jf = [f.name for f in dataclasses.fields(jtasks.WoodscapeSegmenterSwinHPConfig)]
    tf = [f.name for f in dataclasses.fields(ttasks.WoodscapeSegmenterSwinHPConfig)]
    assert jf == tf
    jo, to = jopt.OptimizerConfig(), topt.OptimizerConfig()
    assert dataclasses.asdict(jo) == dataclasses.asdict(to)
