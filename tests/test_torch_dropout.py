"""Element and attention dropout of the port against the JAX package on the CPU, in
float32: the paper configs' ``drop_rate = attn_drop_rate = 0.1`` with DropPath 0.1, at
the NSIDE 8 model of ``test_torch_train_step.py``.

- Same masks: the port draws every mask from a seeded generator through
  ``layers.keep_mask``, recorded here in call order; the JAX model gets the same masks
  through ``flax.linen.intercept_methods``, which replaces each active
  ``nn.Dropout.__call__`` and ``DropPath.__call__`` by ``where(mask, x / keep, 0)`` on
  the next recorded mask (nothing in the JAX package changes).  Then ``loss_fn`` and
  every parameter gradient of the train step match ``jax.value_and_grad`` within the
  limits of ``test_torch_train_step.py`` (loss rtol 1e-5; each gradient, normalized
  by its largest entry, within 1e-4), with the fused tail (the Pallas kernel in
  interpret mode, ``HEAL_SWIN_FH_INTERPRET=1``) and the unfused one; and
  ``WindowAttention`` (both of its dropout routes) and ``Mlp`` alone, forward within
  2e-5 and gradients within 1e-5 normalized.
- At rate 0, and at eval, the model equals the JAX module (1e-4 absolute, as
  ``test_torch_swin_hp.py``).
- A step is reproducible from its seed; kept shares are within 3 standard deviations
  of 0.9; dropout in training without a generator raises.
- ``WindowAttention``'s routes: active attention dropout takes the XLA branch (no
  kernel wrapper is called, no launch counted); proj dropout alone K16/K17 (or K2/K5
  above C 384) with proj, dropout and LN after; neither, K1.  The routes equal each
  other where no mask applies.
- The port's copy of the paper config equals ``run_configs/_common.py``'s.
"""

import dataclasses
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch import run_configs as trc
from heal_swin_torch.convert import _flatten, _torch_key, state_dict_from_flax
from heal_swin_torch.models import layers as tl
from heal_swin_torch.models import swin_hp as tsh
from heal_swin_torch.models import tasks as ttasks
from heal_swin_torch.ops import window_attention as wa
from heal_swin_torch.training import optimizer as topt
from heal_swin_torch.training.trainer import step_generator, train_step
from heal_swin_tpu.data.data_spec import DataSpec
from heal_swin_tpu.models import layers as jl
from heal_swin_tpu.models import swin_hp as jsh
from heal_swin_tpu.models import tasks as jtasks

NSIDE = 8
NPIX = 8 * NSIDE * NSIDE
F_OUT = 5
SPEC = DataSpec(dim_in=NPIX, f_in=3, f_out=F_OUT, base_pix=8)
CLASS_WEIGHTS = [0.5 + 0.25 * i for i in range(F_OUT)]
GRAD_TOL = 1e-4
ATOL = 1e-4
MODULE_FWD = dict(rtol=2e-5, atol=2e-5)
MODULE_GRAD = 1e-5
KEEP = 0.9


def _cfg_kwargs(fused=True, drop=0.1, attn_drop=0.1, drop_path=0.1, strategy="ring_shift",
                v2=True, cos=True):
    return dict(
        patch_size=4, window_size=16, shift_size=8, shift_strategy=strategy,
        rel_pos_bias="flat", embed_dim=8, depths=[2, 1], num_heads=[2, 2],
        use_cos_attn=cos, use_v2_norm_placement=v2, patch_embed_norm_layer="LayerNorm",
        drop_rate=drop, attn_drop_rate=attn_drop, drop_path_rate=drop_path,
        fused_final_head=fused,
    )


def _batch(seed):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(2, NPIX, 3)).astype(np.float32)
    targets = rng.integers(0, F_OUT, (2, NPIX)).astype(np.int32)
    return imgs, targets


def _noised(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)


def _tasks(kw):
    """The JAX task with noised parameters, and the port's task holding the same."""
    jtask = jtasks.WoodscapeSegmenterSwinHP(
        jtasks.WoodscapeSegmenterSwinHPConfig(
            swin_hp_transformer_config=jsh.SwinHPTransformerConfig(**kw),
            class_weights=CLASS_WEIGHTS), SPEC)
    imgs, _ = _batch(0)
    params = _noised(jtask.model.init(jax.random.PRNGKey(0), jnp.asarray(imgs), True), 1)
    ttask = ttasks.WoodscapeSegmenterSwinHP(
        ttasks.WoodscapeSegmenterSwinHPConfig(
            tsh.SwinHPTransformerConfig(**kw), class_weights=CLASS_WEIGHTS), SPEC,
        device="cpu")
    ttask.model.load_state_dict(state_dict_from_flax(params), strict=True)
    return jtask, params, ttask


def _record(monkeypatch):
    """Record every mask the port draws, in call order."""
    masks = []
    draw = tl.keep_mask

    def recorded(shape, keep, generator, device):
        m = draw(shape, keep, generator, device)
        masks.append(m.clone())
        return m

    monkeypatch.setattr(tl, "keep_mask", recorded)
    return masks


def _injector(masks):
    """A flax interceptor that hands each active ``nn.Dropout`` and ``DropPath`` call
    the next of ``masks`` (the port's, in its call order), and the list of the shapes
    it replaced."""
    it = iter(masks)
    used = []

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name != "__call__" or not isinstance(mod, (fnn.Dropout,
                                                                      jl.DropPath)):
            return next_fun(*args, **kwargs)
        x = args[0]
        det = kwargs.get("deterministic", args[1] if len(args) > 1 else None)
        if isinstance(mod, fnn.Dropout):
            det = mod.deterministic if det is None else det
            shape = x.shape
        else:
            shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        if mod.rate == 0.0 or det:
            return next_fun(*args, **kwargs)
        m = next(it).numpy()
        assert m.size == int(np.prod(shape)), (m.shape, shape)
        used.append(tuple(shape))
        keep = float(1.0 - mod.rate)
        return jnp.where(jnp.asarray(m.reshape(shape)), x / keep, jnp.zeros_like(x))

    return interceptor, used


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
def test_train_step_with_the_same_masks_matches_jax(fused, strategy, v2, cos, monkeypatch):
    monkeypatch.setenv("HEAL_SWIN_FH_INTERPRET", "1")
    jtask, params, ttask = _tasks(_cfg_kwargs(fused, strategy=strategy, v2=v2, cos=cos))
    imgs, targets = _batch(2)
    masks = _record(monkeypatch)
    loss_t, out_t = ttask.loss_fn(torch.from_numpy(imgs), torch.from_numpy(targets),
                                  generator=torch.Generator().manual_seed(5),
                                  deterministic=False)
    loss_t.backward()
    # pos_drop, then per block: attention, proj, DropPath, the MLP's two, DropPath;
    # DropPath at rate 0 in the first block of each stage-0 layer (rates 0, .05, .1)
    n_blocks = 2 + 1 + 2
    assert len(masks) == 1 + 4 * n_blocks + 2 * (n_blocks - 2)
    assert sum(m.ndim == 5 for m in masks) == n_blocks  # the attention probabilities

    interceptor, used = _injector(masks)

    def jloss(p):
        return jtask.loss_fn(p, jnp.asarray(imgs), jnp.asarray(targets),
                             rng=jax.random.PRNGKey(0), deterministic=False)

    with fnn.intercept_methods(interceptor):
        (loss_j, out_j), grads_j = jax.value_and_grad(jloss, has_aux=True)(params)
    assert len(used) == len(masks)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    assert tuple(out_t.shape) == tuple(out_j.shape)
    if fused:
        np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    _assert_grads_match(ttask, grads_j)


def _jax_images(seed):
    return np.random.default_rng(seed).normal(size=(2, NPIX, 3)).astype(np.float32)


@pytest.mark.parametrize("mode", ["eval", "rate0"])
@pytest.mark.parametrize("strategy,v2,cos", [("ring_shift", True, True),
                                             ("nest_roll", False, False)])
def test_rate_zero_and_eval_match_jax(mode, strategy, v2, cos, monkeypatch):
    """At eval (the paper rates) and in training at rate 0 the model is the JAX
    module's deterministic forward, and draws no mask."""
    rates = (0.1, 0.1, 0.1) if mode == "eval" else (0.0, 0.0, 0.0)
    kw = _cfg_kwargs(strategy=strategy, v2=v2, cos=cos, drop=rates[0], attn_drop=rates[1],
                     drop_path=rates[2])
    x = _jax_images(0)
    jmodel = jsh.SwinHPTransformerSys(jsh.SwinHPTransformerConfig(**kw), SPEC)
    params = _noised(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), True), 1)
    det = mode == "eval"
    feats_j = np.asarray(jmodel.apply(params, jnp.asarray(x), det, False))
    logits_j = np.asarray(jmodel.apply(params, jnp.asarray(x), det))
    tmodel = tsh.SwinHPTransformerSys(tsh.SwinHPTransformerConfig(**kw), SPEC, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(params), strict=True)
    tmodel.train(mode == "rate0")
    masks = _record(monkeypatch)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(0)
        feats_t = tmodel(torch.from_numpy(x), tail=False, generator=gen)
        logits_t = tmodel(torch.from_numpy(x), generator=gen)
    assert not masks
    np.testing.assert_allclose(feats_t.numpy(), feats_j, atol=ATOL)
    np.testing.assert_allclose(logits_t.numpy(), logits_j, atol=ATOL)


def _load_module(mod, variables):
    flat = _flatten(variables["params"])
    sd = dict(_torch_key(path, value, 1) for path, value in flat.items())
    mod.load_state_dict({k: torch.from_numpy(np.array(v, dtype=np.float32))
                         for k, v in sd.items()}, strict=True)


@pytest.mark.parametrize("cos", [True, False], ids=["cos", "dot"])
@pytest.mark.parametrize("attn_drop,proj_drop", [(0.1, 0.1), (0.0, 0.1)],
                         ids=["attn_drop", "proj_drop_only"])
def test_window_attention_with_the_same_masks_matches_jax(cos, attn_drop, proj_drop,
                                                          monkeypatch):
    """``WindowAttention`` in training with a mask and the v2 LayerNorm: the XLA branch
    (attention dropout) and the K16 route (proj dropout alone), forward and every
    gradient, against the JAX module's XLA branch on the same masks."""
    B, nW, ws, C, h = 2, 3, 16, 32, 2
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, nW, ws, C)).astype(np.float32)
    groups = rng.integers(0, 3, (nW, ws)).astype(np.int32)
    rel_index = tsh._rel_pos_index_nested(ws)
    ln_s = (1 + 0.1 * rng.normal(size=C)).astype(np.float32)
    ln_b = (0.1 * rng.normal(size=C)).astype(np.float32)
    dz = rng.normal(size=x.shape).astype(np.float32)
    jmod = jl.WindowAttention(num_heads=h, attn_drop=attn_drop, proj_drop=proj_drop,
                              use_cos_attn=cos, rel_pos_index=rel_index,
                              rel_pos_table_size=49, rel_pos_init_zero=False)
    variables = _noised(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), groups, True,
                                  (ln_s, ln_b)), 4)
    tmod = tl.WindowAttention(C, h, attn_drop=attn_drop, proj_drop=proj_drop,
                              use_cos_attn=cos, rel_pos_index=rel_index,
                              rel_pos_table_size=49)
    _load_module(tmod, variables)
    ln = tl.LayerNorm(C)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(ln_s))
        ln.bias.copy_(torch.from_numpy(ln_b))
    masks = _record(monkeypatch)
    xt = torch.from_numpy(x).requires_grad_()
    out_t = tmod.train()(xt, torch.from_numpy(groups), ln=ln,
                         generator=torch.Generator().manual_seed(7))
    grads_t = torch.autograd.grad(out_t, [xt] + list(tmod.parameters()), torch.from_numpy(dz))
    assert [m.ndim for m in masks] == ([5, 4] if attn_drop else [2])

    interceptor, used = _injector(masks)

    def jfwd(v, xj):
        return jmod.apply(v, xj, groups, False, (ln_s, ln_b))

    with fnn.intercept_methods(interceptor):
        out_j, vjp = jax.vjp(jfwd, variables, jnp.asarray(x))
        gv, gx = vjp(jnp.asarray(dz))
    assert len(used) == len(masks)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **MODULE_FWD)
    want = {"x": np.asarray(gx)}
    want.update({k: torch.as_tensor(np.array(v)).numpy() for k, v in (
        _torch_key(path, value, 1) for path, value in _flatten(gv["params"]).items())})
    names = ["x"] + [n for n, _ in tmod.named_parameters()]
    for name, g in zip(names, grads_t):
        w = want[name]
        scale = max(np.abs(w).max(), 1e-8)
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=MODULE_GRAD,
                                   err_msg=name)


def test_mlp_with_the_same_masks_matches_jax(monkeypatch):
    """``Mlp`` in training: dropout after the GELU and after fc2, forward and every
    gradient against the JAX module on the same masks."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 24, 32)).astype(np.float32)
    dz = rng.normal(size=x.shape).astype(np.float32)
    jmod = jl.Mlp(hidden_features=128, out_features=32, drop=0.1)
    variables = _noised(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), True), 6)
    tmod = tl.Mlp(32, 128, 32, drop=0.1)
    _load_module(tmod, variables)
    masks = _record(monkeypatch)
    xt = torch.from_numpy(x).requires_grad_()
    out_t = tmod.train()(xt, torch.Generator().manual_seed(8))
    grads_t = torch.autograd.grad(out_t, [xt] + list(tmod.parameters()), torch.from_numpy(dz))
    assert [tuple(m.shape) for m in masks] == [(2, 24, 128), (2, 24, 32)]
    interceptor, used = _injector(masks)
    with fnn.intercept_methods(interceptor):
        out_j, vjp = jax.vjp(lambda v, xj: jmod.apply(v, xj, False), variables,
                             jnp.asarray(x))
        gv, gx = vjp(jnp.asarray(dz))
    assert len(used) == 2
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **MODULE_FWD)
    want = {"x": np.asarray(gx)}
    want.update(dict(_torch_key(p, v, 1) for p, v in _flatten(gv["params"]).items()))
    for name, g in zip(["x"] + [n for n, _ in tmod.named_parameters()], grads_t):
        w = np.asarray(want[name])
        scale = max(np.abs(w).max(), 1e-8)
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=MODULE_GRAD,
                                   err_msg=name)


def test_train_step_with_dropout_is_reproducible_from_the_seed(monkeypatch):
    """With the paper rates, two runs of two steps from the same weights and step seeds
    draw the same masks and give the same losses and weights, a third seed other masks
    and another loss; the global RNG is never drawn from."""
    kw = _cfg_kwargs()
    imgs, targets = _batch(6)
    masks = _record(monkeypatch)

    def run(seed):
        masks.clear()
        task = ttasks.WoodscapeSegmenterSwinHP(
            ttasks.WoodscapeSegmenterSwinHPConfig(tsh.SwinHPTransformerConfig(**kw)), SPEC,
            device="cpu", generator=torch.Generator().manual_seed(3))
        opt = topt.make_optimizer(task.model.parameters(), task.optimizer_config)
        mstate = task.metric_init()
        losses = []
        for step in range(2):
            loss, mstate = train_step(task, opt, mstate, torch.from_numpy(imgs),
                                      torch.from_numpy(targets),
                                      step_generator(seed, step, "cpu"))
            losses.append(float(loss))
        return losses, task.model.state_dict(), list(masks)

    rng_state = torch.random.get_rng_state()
    (la, sa, ma), (lb, sb, mb), (lc, _, mc) = run(0), run(0), run(1)
    assert torch.equal(torch.random.get_rng_state(), rng_state)
    assert len(ma) == len(mb) == len(mc) > 0
    assert all(torch.equal(a, b) for a, b in zip(ma, mb))
    assert not all(torch.equal(a, c) for a, c in zip(ma, mc))
    assert la == lb and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert la[0] != lc[0]


def test_kept_share_is_within_three_standard_deviations_of_0_9(monkeypatch):
    """``Dropout(0.1)`` keeps each entry with probability 0.9 and scales it by 1/0.9;
    the element and attention masks of a train step keep 0.9 of their entries, each
    mask and all together within 3 standard deviations."""
    x = torch.randn(64, 4096)
    y = tl.Dropout(0.1).train()(x, torch.Generator().manual_seed(1))
    kept = y != 0
    n = x.numel()
    assert abs(float(kept.float().mean()) - KEEP) <= 3 * (KEEP * (1 - KEEP) / n) ** 0.5
    torch.testing.assert_close(y[kept], x[kept] / KEEP, rtol=0, atol=0)

    _, _, task = _tasks(_cfg_kwargs(drop_path=0.0))
    masks = _record(monkeypatch)
    imgs, targets = _batch(7)
    task.loss_fn(torch.from_numpy(imgs), torch.from_numpy(targets),
                 generator=torch.Generator().manual_seed(2), deterministic=False)
    assert len(masks) == 1 + 4 * 5
    for m in masks + [torch.cat([m.reshape(-1) for m in masks])]:
        sd = (KEEP * (1 - KEEP) / m.numel()) ** 0.5
        assert abs(float(m.float().mean()) - KEEP) <= 3 * sd, m.shape


def test_dropout_in_training_without_a_generator_raises():
    """``Dropout`` and a model with the paper rates raise in training without a
    generator; at eval, or at rate 0, they run without one."""
    x = torch.randn(4, 8)
    with pytest.raises(ValueError, match="Dropout in training needs"):
        tl.Dropout(0.1).train()(x)
    assert torch.equal(tl.Dropout(0.1).eval()(x), x)
    assert torch.equal(tl.Dropout(0.0).train()(x), x)
    task = ttasks.WoodscapeSegmenterSwinHP(
        ttasks.WoodscapeSegmenterSwinHPConfig(
            tsh.SwinHPTransformerConfig(**_cfg_kwargs(drop_path=0.0))), SPEC, device="cpu")
    imgs, targets = _batch(1)
    with pytest.raises(ValueError, match="Dropout in training needs"):
        task.loss_fn(torch.from_numpy(imgs), torch.from_numpy(targets), deterministic=False)
    task.loss_fn(torch.from_numpy(imgs), torch.from_numpy(targets))  # eval


def _spy_routes(monkeypatch):
    calls = []
    for name in ("window_attention_qkv_epi", "window_attention_qkv", "window_attention"):
        fn = getattr(wa, name)
        monkeypatch.setattr(
            wa, name, lambda *a, _fn=fn, _n=name, **k: (calls.append((_n, k.get("use_cos"))),
                                                       _fn(*a, **k))[1])
    return calls


@pytest.mark.parametrize("dim,heads", [(32, 2), (416, 13)])
@pytest.mark.parametrize("cos", [True, False], ids=["cos", "dot"])
def test_window_attention_dropout_routes(monkeypatch, dim, heads, cos):
    """Attention dropout active: the XLA branch, no kernel wrapper called and no launch
    counted ("pallas" raises); proj dropout alone: K16 (cosine too) or K2 above C 384;
    neither: K1 for cosine at C <= 384.  At eval the three routes give the same
    output and gradients (f32, the same math in another order; gradients normalized
    by their largest entry)."""
    calls = _spy_routes(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 16, dim, generator=gen)
    groups = torch.randint(0, 3, (3, 16), generator=gen, dtype=torch.int32)
    ln = tl.LayerNorm(dim)

    def module(attn_drop, proj_drop, impl="auto"):
        mod = tl.WindowAttention(dim, heads, attn_drop=attn_drop, proj_drop=proj_drop,
                                 use_cos_attn=cos, attention_impl=impl)
        with torch.no_grad():
            for p in list(mod.parameters()):
                p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) * 0.2)
        return mod

    launches = dict(wa.launches)
    small = dim <= wa.KERNEL_MAX_C
    for (ad, pd), want in (((0.1, 0.1), []), ((0.1, 0.0), []),
                           ((0.0, 0.1), [("window_attention_qkv" if small else
                                          "window_attention", cos)]),
                           ((0.0, 0.0), [("window_attention_qkv_epi" if small and cos else
                                          "window_attention_qkv" if small else
                                          "window_attention", None if small and cos else cos)])):
        calls.clear()
        module(ad, pd).train()(x, groups, ln=ln, generator=torch.Generator().manual_seed(2))
        assert calls == want, (ad, pd)
    assert wa.launches == launches
    with pytest.raises(ValueError, match="attention dropout"):
        module(0.1, 0.0, "pallas").train()(x, groups, ln=ln, generator=gen)

    mod = module(0.0, 0.0).eval()
    xr = x.clone().requires_grad_()
    dz = torch.randn(x.shape, generator=gen)
    leaves = [xr] + list(mod.parameters()) + list(ln.parameters())
    routes = [mod._dense_route(xr, groups, ln, None),
              mod._kernel_route(xr, groups, ln, None, epi=False)]
    if small and cos:
        routes.append(mod._kernel_route(xr, groups, ln, None, epi=True))
    ref = routes[0]
    ref_grads = torch.autograd.grad(ref, leaves, dz)
    for out in routes[1:]:
        torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
        for g, w in zip(torch.autograd.grad(out, leaves, dz), ref_grads):
            scale = float(w.abs().max().clamp_min(1e-8))
            torch.testing.assert_close(g / scale, w / scale, rtol=0, atol=MODULE_GRAD)


def test_paper_config_copy_matches_run_configs():
    """The port's ``run_configs`` equal the repo's ``run_configs/_common.py`` field by
    field, with the same class weights and learning rate."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "run_configs"))
    try:
        import _common
    finally:
        sys.path.pop(0)
    want = dataclasses.asdict(_common.paper_swin_hp_config())
    got = dataclasses.asdict(trc.paper_swin_hp_config())
    assert got == want
    assert trc.SYNWOODSCAPE_LARGE_WEIGHTS == _common.SYNWOODSCAPE_LARGE_WEIGHTS
    assert trc.PAPER_LR == _common.PAPER_LR
    assert trc.paper_swin_hp_config(attention_impl="xla").attention_impl == "xla"
    assert trc.paper_swin_hp_config().compute_dtype == torch.float32
