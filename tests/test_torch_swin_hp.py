"""heal_swin_torch HEAL-SWIN-UNet and segmentation predict against the JAX package on
the CPU, in float32, at the size of ``test_fused_predict_matches_argmax``.

Every JAX parameter gets numpy noise before conversion: zero-init rel-pos tables,
equal logit scales and LN ones/zeros would hide indexing and routing mistakes.
Tolerance 1e-4 absolute: the same f32 math in another order through ~10 blocks
(measured differences ~1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch.convert import state_dict_from_flax
from heal_swin_torch.models import swin_hp as tsh
from heal_swin_torch.models import tasks as ttasks
from heal_swin_tpu.data.data_spec import DataSpec
from heal_swin_tpu.models import swin_hp as jsh
from heal_swin_tpu.models import tasks as jtasks

NSIDE = 8
NPIX = 8 * NSIDE * NSIDE
SPEC = DataSpec(dim_in=NPIX, f_in=3, f_out=5, base_pix=8)
ATOL = 1e-4


def _cfg_kwargs(strategy, v2, cos):
    return dict(
        patch_size=4, window_size=16, shift_size=8, shift_strategy=strategy,
        rel_pos_bias="flat", embed_dim=8, depths=[2, 1], num_heads=[2, 2],
        use_cos_attn=cos, use_v2_norm_placement=v2, patch_embed_norm_layer="LayerNorm",
        drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0,
    )


def _jax_params(model, x, seed):
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x), True)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)


def _images(seed):
    return np.random.default_rng(seed).normal(size=(2, NPIX, 3)).astype(np.float32)


CASES = [(s, v2, cos) for s in ("ring_shift", "nest_grid_shift", "nest_roll")
         for v2, cos in ((True, True), (False, False), (True, False), (False, True))]


@pytest.mark.parametrize("strategy,v2,cos", CASES)
def test_model_matches_jax(strategy, v2, cos):
    """tail=False features and logits; cosine runs the K1 route at every width here,
    scaled-dot the qkv-matmul + K2 route."""
    kw = _cfg_kwargs(strategy, v2, cos)
    x = _images(0)
    jmodel = jsh.SwinHPTransformerSys(jsh.SwinHPTransformerConfig(**kw), SPEC)
    params = _jax_params(jmodel, x, 1)
    feats_j = np.asarray(jmodel.apply(params, jnp.asarray(x), True, False))
    logits_j = np.asarray(jmodel.apply(params, jnp.asarray(x), True))

    tmodel = tsh.SwinHPTransformerSys(tsh.SwinHPTransformerConfig(**kw), SPEC)
    tmodel.load_state_dict(state_dict_from_flax(params), strict=True)
    tmodel.eval()
    with torch.no_grad():
        feats_t = tmodel(torch.from_numpy(x), tail=False)
        logits_t = tmodel(torch.from_numpy(x))
    assert feats_t.shape == feats_j.shape and logits_t.dtype == torch.float32
    np.testing.assert_allclose(feats_t.numpy(), feats_j, atol=ATOL)
    np.testing.assert_allclose(logits_t.numpy(), logits_j, atol=ATOL)


@pytest.mark.parametrize("strategy,v2,cos", [
    ("ring_shift", True, True), ("nest_grid_shift", False, False), ("nest_roll", True, False),
])
def test_predict_matches_jax(strategy, v2, cos, monkeypatch):
    """The port's predict (plain K3 on CPU) vs JAX task.predict through the Pallas
    predict kernel in interpret mode: equal except at near-ties (top-2 JAX logits
    within 1e-5, where summation order alone may reorder them)."""
    monkeypatch.setenv("HEAL_SWIN_FH_INTERPRET", "1")
    kw = _cfg_kwargs(strategy, v2, cos)
    x = _images(2)
    jtask = jtasks.WoodscapeSegmenterSwinHP(
        jtasks.WoodscapeSegmenterSwinHPConfig(
            swin_hp_transformer_config=jsh.SwinHPTransformerConfig(**kw)), SPEC)
    params = _jax_params(jtask.model, x, 3)
    preds_j = np.asarray(jtask.predict(params, jnp.asarray(x)))
    logits_j = np.asarray(jtask.model.apply(params, jnp.asarray(x), True))

    ttask = ttasks.WoodscapeSegmenterSwinHP(
        ttasks.WoodscapeSegmenterSwinHPConfig(tsh.SwinHPTransformerConfig(**kw)), SPEC)
    preds_t = ttask.predict(state_dict_from_flax(params), torch.from_numpy(x))
    assert preds_t.shape == (2, NPIX) and preds_t.dtype == torch.int32
    top2 = np.sort(logits_j, axis=-1)[..., -2:]
    ok = (top2[..., 1] - top2[..., 0]) >= 1e-5
    np.testing.assert_array_equal(preds_t.numpy()[ok], preds_j[ok])
    assert ok.mean() > 0.99

    # the unfused tail (fused_final_head=False) predicts the same classes
    ttask.model.config = dataclasses.replace(ttask.model.config, fused_final_head=False)
    np.testing.assert_array_equal(ttask.predict(None, torch.from_numpy(x)).numpy()[ok],
                                  preds_j[ok])


def test_block_geometry_and_unported_options():
    """A stage with N <= ws runs one unshifted window of N tokens; the options that
    wait for later work raise."""
    cfg = tsh.SwinHPTransformerConfig(**_cfg_kwargs("ring_shift", True, True))
    blk = tsh.SwinHPBlock(cfg, dim=8, input_resolution=16, base_pix=8, num_heads=2,
                          shift_size=8, drop_path=0.0)
    assert blk.window_size == 16 and blk.shift_kind == "none" and blk.win_groups is None
    blk = tsh.SwinHPBlock(cfg, dim=8, input_resolution=128, base_pix=8, num_heads=2,
                          shift_size=8, drop_path=0.0)
    assert blk.shift_kind == "perm" and tuple(blk.win_groups.shape) == (8, 16)
    with pytest.raises(ValueError, match="built for 128 tokens"):
        blk(torch.zeros(1, 64, 8))
    with pytest.raises(NotImplementedError, match="use_checkpoint"):
        tsh.SwinHPTransformerSys(dataclasses.replace(cfg, use_checkpoint=True), SPEC)


def test_init_is_seeded_and_device_explicit():
    cfg = tsh.SwinHPTransformerConfig(**_cfg_kwargs("nest_roll", False, True))
    a = tsh.SwinHPTransformerSys(cfg, SPEC, device="cpu",
                                 generator=torch.Generator().manual_seed(7))
    b = tsh.SwinHPTransformerSys(cfg, SPEC, generator=torch.Generator().manual_seed(7))
    c = tsh.SwinHPTransformerSys(cfg, SPEC, generator=torch.Generator().manual_seed(8))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["layers.0.blocks.0.attn.qkv.weight"],
                           sc["layers.0.blocks.0.attn.qkv.weight"])
    w = sa["layers.0.blocks.0.mlp.fc1.weight"]
    assert abs(float(w.std()) - 0.02) < 0.005 and float(w.abs().max()) <= 2.0
    assert torch.equal(sa["layers.0.blocks.0.attn.logit_scale"],
                       torch.full((2, 1, 1), float(np.log(10.0))))


def test_drop_path_drops_whole_samples():
    from heal_swin_torch.models.layers import DropPath

    dp = DropPath(0.5).train()
    y = dp(torch.ones(64, 3, 4), torch.Generator().manual_seed(0)).reshape(64, -1)
    assert set(y.unique().tolist()) == {0.0, 2.0}  # kept samples scaled by 1/keep
    assert torch.equal(y.amin(1), y.amax(1))  # one draw per sample
    assert torch.equal(dp.eval()(torch.ones(2, 3)), torch.ones(2, 3))


def test_config_fields_match_jax():
    """One config drives both packages: same field names and defaults."""
    jf = {f.name: f for f in dataclasses.fields(jsh.SwinHPTransformerConfig)}
    tf = {f.name: f for f in dataclasses.fields(tsh.SwinHPTransformerConfig)}
    assert list(jf) == list(tf)
    j, t = jsh.SwinHPTransformerConfig(), tsh.SwinHPTransformerConfig()
    assert all(getattr(j, k) == getattr(t, k) for k in jf)
    assert tsh.SwinHPTransformerConfig(dtype="bfloat16").compute_dtype == torch.bfloat16
