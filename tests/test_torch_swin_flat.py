"""heal_swin_torch's flat SWIN-UNet and its converter against the JAX package on the
CPU, in float32, at a small size: two stages, embed 32, window 8 x 8, patch 2, on 32 x 64
images (H % (merge * ph * wh) = 32 % 32 = 0).  Stage 0 (16 x 32 tokens) has eight 64-token
windows, its second block shifted by (4, 4) under the 9-region mask; stage 1 (8 x 16) is
no larger than the window in height, so it takes the whole stage (128 tokens) as its one
window, unshifted.

Every JAX parameter gets numpy noise before conversion, so that LN ones and zeros, equal
logit scales and the init's small tables cannot hide an indexing or layout mistake.
Tolerance 1e-5 absolute on features and logits (the same f32 math in another order).
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch.convert import state_dict_from_flax
from heal_swin_torch.models import swin_flat as tsf
from heal_swin_tpu.data.data_spec import DataSpec
from heal_swin_tpu.models import swin_flat as jsf

H, W = 32, 64
SPEC = DataSpec(dim_in=(H, W), f_in=3, f_out=5)
ATOL = 1e-5


def cfg_kwargs(**over):
    kw = dict(patch_size=2, window_size=8, shift_size=4, embed_dim=32, depths=[2, 2],
              num_heads=[1, 2], use_cos_attn=True, use_v2_norm_placement=True,
              drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0)
    kw.update(over)
    return kw


CASES = {
    "cosine_v2_masked": {},
    "scaled_dot_v1": dict(use_cos_attn=False, use_v2_norm_placement=False),
    "ape": dict(ape=True),
    "patch_embed_norm": dict(patch_embed_norm_layer="LayerNorm", use_cos_attn=False),
    "unmasked_no_bias": dict(use_masking=False, use_rel_pos_bias=False),
    "rect_patch": dict(patch_size=(2, 1), shift_size=(4, 2), embed_dim=16, num_heads=[2, 2]),
}


def jax_params(model, x, seed):
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x), True)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)


def images(seed, n=2):
    return np.random.default_rng(seed).normal(size=(n, H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_jax(case):
    """Features (``tail=False``) and logits of the port's model, with the JAX weights
    carried across by the flat converter, against the JAX model's."""
    kw = cfg_kwargs(**CASES[case])
    x = images(0)
    jmodel = jsf.SwinTransformerSys(jsf.SwinTransformerConfig(**kw), SPEC)
    params = jax_params(jmodel, x, 1)
    feats_j = np.asarray(jmodel.apply(params, jnp.asarray(x), True, False))
    logits_j = np.asarray(jmodel.apply(params, jnp.asarray(x), True))

    tmodel = tsf.SwinTransformerSys(tsf.SwinTransformerConfig(**kw), SPEC, device="cpu")
    patch = tmodel.config.patch_size
    tmodel.load_state_dict(state_dict_from_flax(params, patch), strict=True)
    tmodel.eval()
    with torch.no_grad():
        feats_t = tmodel(torch.from_numpy(x), tail=False)
        logits_t = tmodel(torch.from_numpy(x))
    assert tuple(logits_t.shape) == (2, H, W, 5) and logits_t.dtype == torch.float32
    assert tuple(feats_t.shape) == feats_j.shape
    np.testing.assert_allclose(feats_t.numpy(), feats_j, atol=ATOL)
    np.testing.assert_allclose(logits_t.numpy(), logits_j, atol=ATOL)


@pytest.mark.parametrize("case", ["cosine_v2_masked", "ape", "patch_embed_norm", "rect_patch"])
def test_converter_maps_every_leaf(case):
    """Every leaf of the JAX flat tree lands on one port key with its values, and the
    inverse layout gives the leaf back bit for bit; the port's module names give the JAX
    top-level names (``train.param_counts``)."""
    from heal_swin_torch.train import param_counts

    kw = cfg_kwargs(**CASES[case])
    jmodel = jsf.SwinTransformerSys(jsf.SwinTransformerConfig(**kw), SPEC)
    params = jax_params(jmodel, images(0, 1), 2)
    flat = flax.traverse_util.flatten_dict(params["params"], sep="/")
    tmodel = tsf.SwinTransformerSys(tsf.SwinTransformerConfig(**kw), SPEC, device="cpu")
    ph, pw = tmodel.config.patch_size
    sd = state_dict_from_flax(params, (ph, pw))
    assert len(sd) == len(flat) and set(sd) == set(tmodel.state_dict())
    back = {}
    for key, v in sd.items():
        v = v.numpy()
        if key == "patch_embed.proj.weight":
            v = v.transpose(2, 3, 1, 0).reshape(ph * pw * v.shape[1], v.shape[0])
        elif key == "output.weight":
            v = v[:, :, 0, 0].T
        elif v.ndim == 2 and "relative_position" not in key:
            v = v.T
        back[key] = v
    used = set()
    for path, value in flat.items():
        hits = [k for k, v in back.items() if v.shape == value.shape and np.array_equal(v, value)]
        assert len(hits) == 1, path
        used.add(hits[0])
    assert used == set(sd)

    tmodel.load_state_dict(sd, strict=True)
    counts = param_counts(tmodel)
    want = {f"total_params.{mod}": sum(int(np.size(p)) for p in jax.tree.leaves(sub))
            for mod, sub in params["params"].items()}
    want["total_params"] = sum(int(np.size(p)) for p in jax.tree.leaves(params))
    assert counts == want


def test_shift_masks_and_geometry():
    """The 9-region groups and the (-sh, -sw) roll: a block's groups equal the JAX
    model's, a shifted block rolls the grid, and the whole-stage window takes over where
    the stage is no larger than the window."""
    cfg = tsf.SwinTransformerConfig(**cfg_kwargs()).normalized()
    blk = tsf.SwinBlock2D(cfg, 32, (16, 32), 1, (4, 4), 0.0)
    want = jsf._shift_win_groups(16, 32, 8, 8, 4, 4)
    assert blk.win_groups.dtype == torch.int32
    np.testing.assert_array_equal(blk.win_groups.numpy(), want)
    assert want.shape == (8, 64) and len(np.unique(want)) == 9
    np.testing.assert_array_equal(tsf.rel_pos_index_2d(8, 8), jsf._rel_pos_index_2d(8, 8))
    assert tsf.rel_pos_index_2d(8, 8).max() == 224  # a 225-entry table
    whole = tsf.SwinBlock2D(cfg, 64, (8, 16), 2, (4, 4), 0.0)
    assert whole.window == (8, 16) and whole.shift == (0, 0) and whole.win_groups is None
    x = torch.arange(2 * 16 * 32 * 3, dtype=torch.float32).reshape(2, 16, 32, 3)
    np.testing.assert_array_equal(
        tsf.window_partition(x, 8, 8).numpy(),
        np.asarray(jsf._window_partition(jnp.asarray(x.numpy()), 8, 8)))
    with pytest.raises(ValueError, match="built for 16 x 32"):
        blk(torch.zeros(1, 100, 32))
    with pytest.raises(ValueError, match="divisible"):
        tsf.SwinTransformerSys(cfg, DataSpec(dim_in=(40, 64), f_in=3, f_out=5), device="cpu")


def test_init_is_seeded_and_tables_trunc_normal():
    """The flat model's rel-pos tables are trunc-normal (the HP model's zeros), drawn
    from the model's generator; a seed gives the same weights."""
    cfg = tsf.SwinTransformerConfig(**cfg_kwargs())
    a = tsf.SwinTransformerSys(cfg, SPEC, device="cpu", generator=torch.Generator().manual_seed(4))
    b = tsf.SwinTransformerSys(cfg, SPEC, device="cpu", generator=torch.Generator().manual_seed(4))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    table = sa["layers.0.blocks.0.attn.relative_position_bias_table"]
    assert tuple(table.shape) == (225, 1)
    assert 0.01 < float(table.std()) < 0.03 and float(table.abs().max()) <= 2.0
    assert torch.equal(sa["layers.0.blocks.0.attn.logit_scale"],
                       torch.full((1, 1, 1), float(np.log(10.0))))


def test_config_fields_match_jax():
    jf = [f.name for f in dataclasses.fields(jsf.SwinTransformerConfig)]
    tf = [f.name for f in dataclasses.fields(tsf.SwinTransformerConfig)]
    assert jf == tf
    j, t = jsf.SwinTransformerConfig(), tsf.SwinTransformerConfig()
    assert all(getattr(j, k) == getattr(t, k) for k in jf)
    assert dataclasses.asdict(t.normalized()) == dataclasses.asdict(j.normalized())


@pytest.mark.parametrize("case", ["cosine_v2_masked", "rect_patch"])
def test_adam_state_carries_a_live_optax_run(case):
    """Two optax Adam steps on the JAX flat tree, their state carried into torch's Adam
    through ``adam_state_from_optax`` (the flat model's patch taken from its config): its
    third step gives the parameters of optax's third step."""
    import optax

    from heal_swin_torch.convert import adam_state_from_optax
    from heal_swin_torch.training import optimizer as topt
    from heal_swin_tpu.training import optimizer as jopt

    kw = cfg_kwargs(**CASES[case])
    jmodel = jsf.SwinTransformerSys(jsf.SwinTransformerConfig(**kw), SPEC)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                  jnp.asarray(images(0, 1)), True))
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
             for _ in range(3)]
    tx = jopt.make_optimizer(jopt.OptimizerConfig(learning_rate=3e-3, weight_decay=1e-2))
    state, p = tx.init(params), params
    for g in grads[:2]:
        upd, state = tx.update(g, state, p)
        p = optax.apply_updates(p, upd)
    tmodel = tsf.SwinTransformerSys(tsf.SwinTransformerConfig(**kw), SPEC, device="cpu")
    patch = tmodel.config.patch_size
    tmodel.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, p), patch))
    opt = topt.make_optimizer(tmodel.parameters(),
                              topt.OptimizerConfig(learning_rate=1.0, weight_decay=1e-2))
    opt.load_state_dict(adam_state_from_optax(jax.device_get(state), tmodel, opt))
    g3 = state_dict_from_flax(grads[2], patch)
    for name, prm in tmodel.named_parameters():
        prm.grad = g3[name].clone()
    opt.step()
    upd, _ = tx.update(grads[2], state, p)
    want = state_dict_from_flax(jax.tree.map(np.asarray, optax.apply_updates(p, upd)), patch)
    for name, prm in tmodel.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
