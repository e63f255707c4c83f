"""The depth tail in float32 and the depth paper config's train step, against the JAX
package on the CPU.

On the card the f32 K8 and K9 (``csrc/tail_f32.cuh``) are the f32 K6/K7's row
kernels with the masked depth loss: a block holds one expand slice and walks the
sub-pixels in an outer loop, each over the 128-row tiles b, b + grid, ... of the bf16
kernels' partition; K8 writes one partial row [sum loss, count] a block and its f32
logits as the predictions; K9 is its row kernel (dx, the f32 dh, partial rows [dWh |
dgamma | dbeta]), ``reduce_rows`` and ``gemm_tn_f32``.  Their twins run here in f32:

- At the paper head (C 96, p 4) for every loss kind and head (l2, l1, huber with delta
  0.5 and l2 with one channel; nll and l2 with a logvar channel), on grids of 1, 2 and 5
  blocks over T 320 (two full tiles and a half one): K8's partial rows summed and K9's
  three steps composed against ``fused_final_head_depth(interpret=True)`` and its
  ``jax.vjp`` on the same numpy inputs.  Limits: the loss within 1e-5 relative, the count
  equal, the predictions within 2e-5 (absolute and relative), every gradient, normalized
  by its largest entry, within 5e-6 (as ``test_torch_depth_tail_sequence.py``).  The f32
  predictions are the logits themselves, bit for bit, and the wrappers on CPU tensors
  are their twins with f32 results.
- The depth paper config (``heal_swin_torch.run_configs.paper_depth_config``: dropout,
  attention dropout and DropPath 0.1, l2 on standardized depths with background masked)
  cut to NSIDE 8, window 16, embed 16 and depths [2, 1], in f32: its train-mode
  ``loss_fn`` and every parameter gradient against ``jax.value_and_grad`` of the JAX
  task's, the port's dropout masks handed to the JAX model through
  ``flax.linen.intercept_methods`` (as ``test_torch_dropout.py``), on the fused tail (the
  Pallas kernel in interpret mode, ``HEAL_SWIN_FH_INTERPRET=1``) and the unfused one.
  Limits: loss rtol 1e-5; each gradient, normalized by its largest entry, within 1e-4.
- ``paper_depth_config`` against ``get_train_run_config()`` and ``get_pl_config()`` of
  ``run_configs/depth_estimation/depth_swin_hp_train_run_config.py``, field by field.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch import run_configs as trc
from heal_swin_torch.convert import state_dict_from_flax
from heal_swin_torch.models import tasks as ttasks
from heal_swin_torch.ops import final_head as fh
from heal_swin_tpu.data.data_config import WoodscapeDepthCommonConfig, WoodscapeHPDepthConfig
from heal_swin_tpu.data.data_spec import DepthDataSpec
from heal_swin_tpu.models import swin_hp as jsh
from heal_swin_tpu.models import tasks as jtasks
from heal_swin_tpu.ops import final_head as jfh
from tests.test_torch_dropout import _injector, _record

T, C, P = 320, 96, 4
GRIDS = (1, 2, 5)
KINDS = [("l2", 1, 1.0), ("l1", 1, 1.0), ("huber", 1, 0.5), ("nll", 2, 1.0), ("l2", 2, 1.0)]
GLOSS = 0.8
F32_TOL = 5e-6
LOSS_RTOL = 1e-5
PRED_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_NAMES = ("dx", "dwe", "dgamma", "dbeta", "dwh")


def _operands(F, seed):
    """x, we, gamma, beta, wh, targets (N(1, 1), 35% inf): f32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    tgt = rng.normal(1.0, 1.0, size=(T, P)).astype(f)
    tgt[rng.uniform(size=(T, P)) < 0.35] = np.inf
    return (rng.normal(size=(T, C)).astype(f), (rng.normal(size=(C, P * C)) * 0.2).astype(f),
            (1.0 + 0.3 * rng.normal(size=C)).astype(f), (0.2 * rng.normal(size=C)).astype(f),
            (rng.normal(size=(C, F)) * 0.3).astype(f), tgt)


def _seed(F):
    return 180 + F


def _ops(F):
    return tuple(torch.from_numpy(a) for a in _operands(F, _seed(F)))


@functools.lru_cache(maxsize=None)
def _pallas(F, kind, delta):
    """(loss, predictions, (dx, dwe, dgamma, dbeta, dwh)) of the Pallas depth tail in
    interpret mode, in f32, for a loss gradient of GLOSS."""
    x, we, g, b, wh, tgt = _operands(F, _seed(F))

    def fn(x, we, g, b, wh):
        return jfh.fused_final_head_depth(x, we, g, b, wh, jnp.asarray(tgt), patch_size=P,
                                          loss_kind=kind, huber_delta=delta, interpret=True,
                                          rblk=64)

    (loss, preds), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (x, we, g, b, wh)))
    grads = vjp((jnp.asarray(GLOSS, jnp.float32), jnp.zeros_like(preds)))
    return float(loss), np.asarray(preds), tuple(np.asarray(a) for a in grads)


def _kw(kind, delta):
    return dict(patch_size=P, loss_kind=kind, huber_delta=delta)


def _close(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=F32_TOL, err_msg=name)


CASES = [pytest.param(kind, F, delta, grid, id=f"{kind}-F{F}-grid{grid}")
         for kind, F, delta in KINDS for grid in GRIDS]


@pytest.mark.parametrize("kind,F,delta,grid", CASES)
def test_f32_depth_twins_at_the_paper_head_match_pallas(kind, F, delta, grid):
    """K8's partial rows and K9's steps, the twins of the f32 kernels' walk, in f32 at the
    paper head, against the Pallas kernel in interpret mode and its VJP."""
    ops = _ops(F)
    kw = _kw(kind, delta)
    loss_j, preds_j, grads_j = _pallas(F, kind, delta)
    part = fh.final_head_depth_loss_partials_plain(*ops, **kw, grid=grid)
    assert part.shape == (grid, 2) and part.dtype == torch.float32
    num, den = fh.reduce_rows_plain(part)
    assert float(den) == float(np.isfinite(ops[5].numpy()).sum())
    np.testing.assert_allclose(float(num / torch.clamp_min(den, 1.0)), loss_j, rtol=LOSS_RTOL)
    _, _, preds = fh.final_head_depth_loss_plain(*ops, **kw)
    assert preds.dtype == torch.float32
    np.testing.assert_allclose(preds.numpy(), preds_j, **PRED_TOL)
    scale = torch.tensor(GLOSS) / torch.clamp_min(den, 1.0)
    dx, dh, bpart = fh.final_head_depth_loss_bwd_rows_plain(*ops, scale, **kw, grid=grid)
    assert dx.dtype == dh.dtype == torch.float32 and bpart.shape == (grid, C * F + 2 * C)
    got = fh.final_head_depth_loss_bwd_sequence_plain(*ops, scale, **kw, grid=grid)
    for name, a, want in zip(GRAD_NAMES, got, grads_j):
        _close(a, want, name)
    whole = fh.final_head_depth_loss_bwd_plain(*ops, scale, **kw)
    for name, a, want in zip(GRAD_NAMES, got, whole):
        _close(a, want, name)
    if F == 2 and kind != "nll":  # the logvar channel gets no gradient
        assert float(got[4][:, 1].abs().max()) == 0.0


@pytest.mark.parametrize("kind,F,delta", KINDS)
def test_f32_depth_predictions_are_the_logits(kind, F, delta):
    """In f32 nothing rounds the predictions: the plain K8's are its f32 logits bit for
    bit (the f32 kernel writes its logits as its predictions), and on CPU tensors the
    K8 / K9 wrappers run their plain versions with f32 results and count no launch."""
    ops = _ops(F)
    kw = _kw(kind, delta)
    before = dict(fh.launches)
    num, den, preds, lf8 = fh.final_head_depth_loss_sums(*ops, **kw, tap_logits=True)
    logits = fh.final_head_logits_plain(*ops[:5], patch_size=P)
    assert torch.equal(lf8, logits) and torch.equal(preds, logits.reshape(T, P * F))
    want = fh.final_head_depth_loss_plain(*ops, **kw)
    assert all(torch.equal(a, b) for a, b in zip((num, den, preds), want))
    scale = torch.tensor(GLOSS) / torch.clamp_min(den, 1.0)
    dx, dh, part, lf9 = fh.final_head_depth_loss_bwd_rows(*ops, scale, **kw, tap_logits=True)
    assert dx.dtype == dh.dtype == torch.float32 and torch.equal(lf9, logits)
    grads = fh.final_head_depth_loss_bwd(*ops, scale, **kw)
    assert all(g.dtype == torch.float32 for g in grads)
    assert all(torch.equal(a, b) for a, b in zip(
        grads, fh.final_head_depth_loss_bwd_plain(*ops, scale, **kw)))
    assert fh.depth_kernels_take(T - T % 64, C, F, kind, torch.float32)
    assert dict(fh.launches) == before


# --- the depth paper config's train step at a small size
NSIDE = 8
NPIX = 8 * NSIDE * NSIDE
SPEC = DepthDataSpec(dim_in=NPIX, f_in=3, f_out=1, base_pix=8)
SMALL = dict(window_size=16, shift_size=8, embed_dim=16, depths=[2, 1], num_heads=[2, 2])
GRAD_TOL = 1e-4


def _small_paper_depth(fused):
    """The paper depth config cut to NSIDE 8's sizes (window 16, embed 16, depths [2, 1]),
    every rate and loss setting kept."""
    return trc.paper_depth_config(**SMALL, fused_final_head=fused)


def _depth_tasks(fused):
    """The JAX depth task with noised parameters, and the port's task holding the same,
    both from the port's copy of the paper depth config."""
    cfg = _small_paper_depth(fused)
    mcfg = cfg.model
    jdata = WoodscapeHPDepthConfig(common_depth=WoodscapeDepthCommonConfig(
        **dataclasses.asdict(cfg.data.common_depth)))
    jtask = jtasks.WoodscapeDepthSwinHP(
        jtasks.WoodscapeDepthSwinHPConfig(
            swin_hp_transformer_config=jsh.SwinHPTransformerConfig(
                **dataclasses.asdict(mcfg.swin_hp_transformer_config)),
            common_depth_config=jtasks.CommonDepthConfig(
                **dataclasses.asdict(mcfg.common_depth_config))), SPEC, jdata)
    params = jtask.init_variables(jax.random.PRNGKey(0), np.zeros((1, NPIX, 3), np.float32))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)
    ttask = ttasks.WoodscapeDepthSwinHP(mcfg, SPEC, cfg.data, device="cpu")
    ttask.model.load_state_dict(state_dict_from_flax(params), strict=True)
    return jtask, params, ttask


def _depth_batch(seed, jtask):
    """Images and network-space targets: metric depths in [0.1, 60] with 35% of the
    pixels background (inf), through the JAX task's transform and normalization."""
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(2, NPIX, 3)).astype(np.float32)
    depth = rng.uniform(0.1, 60.0, size=(2, NPIX)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.35] = np.inf
    return imgs, np.array(jtask._to_network(jnp.asarray(depth)))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_paper_depth_train_step_with_the_same_masks_matches_jax(fused, monkeypatch):
    monkeypatch.setenv("HEAL_SWIN_FH_INTERPRET", "1")
    jtask, params, ttask = _depth_tasks(fused)
    assert ttask._fused_tail_ok() == jtask._fused_tail_ok() == fused
    assert ttask.model.config.compute_dtype == torch.float32
    imgs, targets = _depth_batch(2, jtask)
    masks = _record(monkeypatch)
    loss_t, out_t = ttask.loss_fn(torch.from_numpy(imgs), torch.from_numpy(targets),
                                  generator=torch.Generator().manual_seed(5),
                                  deterministic=False)
    loss_t.backward()
    assert sum(m.ndim == 5 for m in masks) > 0  # the attention probabilities' masks

    interceptor, used = _injector(masks)

    def jloss(p):
        return jtask.loss_fn(p, jnp.asarray(imgs), jnp.asarray(targets),
                             rng=jax.random.PRNGKey(0), deterministic=False)

    with fnn.intercept_methods(interceptor):
        (loss_j, out_j), grads_j = jax.value_and_grad(jloss, has_aux=True)(params)
    assert len(used) == len(masks)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    assert tuple(out_t.shape) == tuple(out_j.shape) == (2, NPIX, 1)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-5)
    want = state_dict_from_flax(jax.tree.map(np.asarray, grads_j))
    named = dict(ttask.model.named_parameters())
    assert set(want) == set(named)
    for name, prm in named.items():
        g, w = prm.grad.numpy(), want[name].numpy()
        scale = max(np.abs(w).max(), 1e-8)
        np.testing.assert_allclose(g / scale, w / scale, atol=GRAD_TOL, err_msg=name)


def _reference_run_config():
    path = (Path(__file__).resolve().parents[1] / "run_configs" / "depth_estimation"
            / "depth_swin_hp_train_run_config.py")
    spec = importlib.util.spec_from_file_location("_depth_swin_hp_train_run_config", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_paper_depth_config_copy_matches_run_configs():
    """The port's ``paper_depth_config`` equals the repo's paper depth run config field
    by field: the model config (architecture, optimizer, depth loss), the data config,
    and the trainer's gradient clipping."""
    ref = _reference_run_config()
    want, pl = ref.get_train_run_config(), ref.get_pl_config()
    got = trc.paper_depth_config()
    assert dataclasses.asdict(got.model) == dataclasses.asdict(want.model)
    assert dataclasses.asdict(got.data) == dataclasses.asdict(want.data)
    assert got.gradient_clip_val == pl.gradient_clip_val == 0
    assert got.model.optimizer_config.learning_rate == trc.PAPER_DEPTH_LR == 0.005
    assert got.model.swin_hp_transformer_config.compute_dtype == torch.float32
    small = _small_paper_depth(True).model.swin_hp_transformer_config
    assert small.drop_rate == small.attn_drop_rate == small.drop_path_rate == 0.1
    assert trc.paper_depth_config(attention_impl="xla").model.swin_hp_transformer_config \
        .attention_impl == "xla"
