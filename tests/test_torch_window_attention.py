"""heal_swin_torch window attention and token ops against the JAX package on the CPU.

The port's plain versions of K1 (qkv + cosine attention + proj [+ LN]) and K2
(attention from qkv) are held against the Pallas kernels run in interpret mode, on
the same numpy inputs.

- float32: 2e-5 absolute and relative, the same f32 math summed in another order
  (the Pallas kernel tests' own bound).
- bfloat16: relative L2 <= 5e-4.  Both sides round to bf16 at the same points (qkv;
  q_hat, k_hat; p; o; output), so they differ only where f32 sums taken in another
  order flip a rounding (measured <= 6.2e-5).  Leaving out any one of those
  roundings moves the result by >= 1.4e-3 relative L2, so the bound pins them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch.ops import window_attention as wa
from heal_swin_torch.ops.permute import permute_tokens
from heal_swin_torch.ops.windowing import get_nest_win_idcs, window_partition, window_reverse
from heal_swin_tpu.ops.window_attention import (
    fused_window_attention,
    fused_window_attention_qkv_epi,
)

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_REL_L2 = 5e-4
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_matches(got, want, dtype):
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert np.isfinite(got).all()
        assert np.linalg.norm(got - want) <= BF16_REL_L2 * np.linalg.norm(want)


def _epi_operands(seed):
    ws, h, C, nw = 16, 2, 32, 16
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        ws=ws, h=h,
        x=rng.normal(size=(nw * ws, C)).astype(f),
        wq=(rng.normal(size=(C, 3 * C)) * 0.1).astype(f),
        bq=(rng.normal(size=(3 * C,)) * 0.1).astype(f),
        wp=(rng.normal(size=(C, C)) * 0.2).astype(f),
        bp=(rng.normal(size=(C,)) * 0.1).astype(f),
        gam=(1.0 + 0.3 * rng.normal(size=C)).astype(f),
        bet=(0.2 * rng.normal(size=C)).astype(f),
        groups=rng.integers(0, 3, (nw, ws)).astype(np.int32),
        bias=rng.normal(size=(h, ws, ws)).astype(f),
        ls=np.exp(rng.normal(size=h)).astype(f),
    )


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("has_mask", [True, False])
@pytest.mark.parametrize("has_ln", [True, False])
def test_qkv_epi_plain_matches_pallas(has_ln, has_mask, dtype):
    """x and the projection weights in ``dtype``; LN params, bias and scales f32, as
    the model hands them to the kernel."""
    jdt, tdt = DTYPES[dtype]
    o = _epi_operands(5)
    ln = (o["gam"], o["bet"]) if has_ln else (None, None)
    want = fused_window_attention_qkv_epi(
        jnp.asarray(o["x"], jdt), jnp.asarray(o["wq"], jdt), jnp.asarray(o["bq"], jdt),
        jnp.asarray(o["wp"], jdt), jnp.asarray(o["bp"], jdt),
        None if ln[0] is None else jnp.asarray(ln[0]),
        None if ln[1] is None else jnp.asarray(ln[1]),
        jnp.asarray(o["groups"]), jnp.asarray(o["bias"]), jnp.asarray(o["ls"]),
        ws=o["ws"], num_heads=o["h"], sm_scale=0.18, has_mask=has_mask, wblk=4,
        interpret=True)
    got = wa.window_attention_qkv_epi_plain(
        *(_t(o[k]).to(tdt) for k in ("x", "wq", "bq", "wp", "bp")),
        None if ln[0] is None else _t(ln[0]), None if ln[1] is None else _t(ln[1]),
        _t(o["groups"]), _t(o["bias"]), _t(o["ls"]), ws=o["ws"], num_heads=o["h"],
        sm_scale=0.18, has_mask=has_mask)
    assert got.dtype == tdt
    _assert_matches(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("use_cos", [True, False])
@pytest.mark.parametrize("has_mask", [True, False])
@pytest.mark.parametrize("has_bias", [True, False])
def test_attention_plain_matches_pallas(use_cos, has_mask, has_bias, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    ws, h, C, nw = 16, 4, 32, 16
    qkv = rng.normal(size=(nw * ws, 3 * C)).astype(np.float32)
    groups = rng.integers(0, 3, (nw, ws)).astype(np.int32)
    bias = rng.normal(size=(h, ws, ws)).astype(np.float32) if has_bias else None
    ls = np.exp(rng.normal(size=h) * 0.3).astype(np.float32) if use_cos else None
    want = fused_window_attention(
        jnp.asarray(qkv, jdt), jnp.asarray(groups),
        None if bias is None else jnp.asarray(bias), None if ls is None else jnp.asarray(ls),
        ws=ws, num_heads=h, use_cos=use_cos, sm_scale=0.35, has_mask=has_mask,
        interpret=True, wblk=4)
    got = wa.window_attention_plain(
        _t(qkv).to(tdt), _t(groups), None if bias is None else _t(bias),
        None if ls is None else _t(ls), ws=ws, num_heads=h, use_cos=use_cos, sm_scale=0.35,
        has_mask=has_mask)
    assert got.dtype == tdt
    _assert_matches(got, want, dtype)


def test_wrappers_dispatch_on_cpu():
    """On CPU tensors "auto" and "xla" run the plain versions and count no launch;
    "pallas" demands the kernel and raises; an unknown impl raises."""
    o = _epi_operands(7)
    args = (_t(o["x"]), _t(o["wq"]), _t(o["bq"]), _t(o["wp"]), _t(o["bp"]), _t(o["gam"]),
            _t(o["bet"]), _t(o["groups"]), _t(o["bias"]), _t(o["ls"]))
    kw = dict(ws=o["ws"], num_heads=o["h"], sm_scale=0.18)
    before, before_shapes = dict(wa.launches), wa.launches_by_shape.copy()
    plain = wa.window_attention_qkv_epi_plain(*args, **kw)
    for impl in ("auto", "xla"):
        assert torch.equal(wa.window_attention_qkv_epi(*args, **kw, impl=impl), plain)
    qkv = _t(o["x"]) @ _t(o["wq"])
    kw2 = dict(ws=o["ws"], num_heads=o["h"], use_cos=True, sm_scale=0.18)
    assert torch.equal(
        wa.window_attention(qkv, _t(o["groups"]), _t(o["bias"]), _t(o["ls"]), **kw2),
        wa.window_attention_plain(qkv, _t(o["groups"]), _t(o["bias"]), _t(o["ls"]), **kw2))
    assert wa.launches == before and wa.launches_by_shape == before_shapes
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        wa.window_attention_qkv_epi(*args, **kw, impl="pallas")
    with pytest.raises(ValueError, match="unknown impl"):
        wa.window_attention(qkv, None, None, _t(o["ls"]), **kw2, has_mask=False, impl="cuda")


def test_clamped_logit_scale():
    ls = torch.tensor([[[0.0]], [[np.log(10.0)]], [[10.0]]])
    np.testing.assert_allclose(wa.clamped_logit_scale(ls).numpy(), [1.0, 10.0, 100.0],
                               rtol=1e-6)


@pytest.mark.parametrize("ws", [4, 16, 64, 256])
def test_nest_win_idcs_and_rel_pos_index_match_jax(ws):
    from heal_swin_torch.models.swin_hp import _rel_pos_index_nested
    from heal_swin_tpu.models.swin_hp import _rel_pos_index_nested as jax_rel_pos_index
    from heal_swin_tpu.ops.windowing import get_nest_win_idcs as jax_nest_win_idcs

    np.testing.assert_array_equal(get_nest_win_idcs(ws), jax_nest_win_idcs(ws))
    np.testing.assert_array_equal(_rel_pos_index_nested(ws), jax_rel_pos_index(ws))


def test_permute_and_windowing_match_jax():
    from heal_swin_tpu.ops.permute import permute_tokens as jax_permute
    from heal_swin_tpu.ops.shifting import get_shift_spec
    from heal_swin_tpu.ops.windowing import window_partition as jax_partition

    spec = get_shift_spec("ring_shift", 8 * 16 * 16, 8, 16, 8)
    x = np.random.default_rng(2).normal(size=(3, spec.npix, 5)).astype(np.float32)
    want = jax_permute(jnp.asarray(x), jnp.asarray(spec.perm), jnp.asarray(spec.inv_perm))
    got = permute_tokens(_t(x), torch.as_tensor(spec.perm, dtype=torch.long))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = permute_tokens(got, torch.as_tensor(spec.inv_perm, dtype=torch.long))
    np.testing.assert_array_equal(back.numpy(), x)
    win = window_partition(_t(x), 16)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jax_partition(jnp.asarray(x), 16)))
    np.testing.assert_array_equal(window_reverse(win, 16, spec.npix).numpy(), x)
