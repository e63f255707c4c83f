"""The decoder tail in float32 on the CPU: the operands the f32 K3/K6/K7 take, the f32
refusals that remain (widths without an instantiation, heads over 16 columns), and the plain
step twins of the f32 K6 and K7 at the paper config's head (C 96, p 4, F 8) against the JAX
package's Pallas kernel in interpret mode.

On the card the f32 K6/K7 (``csrc/final_head_f32.cu``) walk the bf16 kernels' partition:
block b takes the 128-row tiles b, b + grid, ... (in every sub-pixel, the sub-pixels in
an outer loop), so K6's partial rows are ``final_head_loss_partials_plain`` and K7's tile
kernel (dx and one partial row a block, [dWe | dWh | dgamma | dbeta] over the block's rows)
is ``final_head_loss_bwd_rows_f32_plain`` on the same grid.  Here those twins, at grids of
1, 2 and 5 blocks (T 320: two full tiles and a half one), summed by ``reduce_rows_plain``,
are held to ``fused_final_head(interpret=True)`` and its ``jax.vjp`` on the same numpy
inputs: the loss within 1e-5 relative, the confusion matrix equal, every gradient,
normalized by its largest entry, within 5e-6 (the limits of ``test_torch_tail_sequence.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch.ops import final_head as fh
from heal_swin_tpu.ops import final_head as jfh

T, C, P, F = 320, 96, 4, 8
GRIDS = (1, 2, 5)
SCALE = 0.9
F32_TOL = 5e-6
LOSS_RTOL = 1e-5


def _operands(seed=17):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(T, C)).astype(f), (rng.normal(size=(C, P * C)) * 0.2).astype(f),
            (1.0 + 0.3 * rng.normal(size=C)).astype(f), (0.2 * rng.normal(size=C)).astype(f),
            (rng.normal(size=(C, F)) * 0.3).astype(f),
            rng.integers(0, F, (T, P)).astype(np.int32),
            rng.uniform(0.5, 2.0, (T, P)).astype(f))


@functools.lru_cache(maxsize=None)
def _pallas():
    x, we, g, b, wh, y, w = _operands()

    def fn(x, we, g, b, wh):
        return jfh.fused_final_head(x, we, g, b, wh, jnp.asarray(y), jnp.asarray(w),
                                    patch_size=P, interpret=True, rblk=64)

    (loss, cm), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (x, we, g, b, wh)))
    grads = vjp((jnp.asarray(SCALE, jnp.float32), jnp.zeros_like(cm)))
    return float(loss), np.asarray(cm), tuple(np.asarray(a) for a in grads)


def _close(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-8)
    np.testing.assert_allclose(got / scale, want / scale, atol=F32_TOL, err_msg=name)


def test_f32_kernels_take():
    """K6 and K7, and K3 (predict, ``train=False``), take f32 tokens at C 32, 64, 96, 128
    and heads up to 16 columns; the bf16 rule is unchanged."""
    f32, bf = torch.float32, torch.bfloat16
    for c in (32, 64, 96, 128):
        assert fh.kernels_take(262144, c, 8, f32), c
        assert fh.kernels_take(262144, c, 16, f32), c
        assert fh.kernels_take(262144, c, 8, f32, train=False), c  # K3
        assert fh.kernels_take(262144, c, 16, f32, train=False), c
    assert not fh.kernels_take(262144, 96, 17, f32, train=False)
    assert not fh.kernels_take(262144, 48, 8, f32, train=False)
    assert not fh.kernels_take(262144, 96, 17, f32)  # the f32 head's 16 columns
    assert fh.kernels_take(262144, 96, 17, bf) and fh.kernels_take(262144, 96, 32, bf)
    assert not fh.kernels_take(262144, 48, 8, f32)  # no instantiation
    assert not fh.kernels_take(96, 96, 8, f32)  # T % 64
    assert not fh.kernels_take(262144, 96, 8, torch.float16)


def test_f32_tails_without_a_kernel_refuse_on_a_cuda_tensor(monkeypatch):
    """Where the kernels would run (``use_kernel`` forced true, as for a CUDA tensor),
    f32 tokens at C 48 on K3 (predict) raise before any launch, naming the kernel and
    impl="xla", as do an f32 depth tail at C 48 on K8 and K9 (their f32 kernels, like
    the bf16 ones, have no instantiation of that width) and f32 heads of more than 16
    columns on K3, K6 and K7."""
    monkeypatch.setattr(fh, "use_kernel", lambda t, impl: impl != "xla")
    x, we, g, b, wh, y, w = (torch.from_numpy(a) for a in _operands())
    gen = torch.Generator().manual_seed(0)
    t = torch.randn(T, P, generator=gen)
    x48, we48 = torch.randn(T, 48, generator=gen), torch.randn(48, P * 48, generator=gen)
    g48, b48, wh48 = torch.ones(48), torch.zeros(48), torch.randn(48, 2, generator=gen)
    one = torch.ones(())
    before = dict(fh.launches)
    with pytest.raises(ValueError, match=r"\(K3\).*C % 32 == 0 and C <= 128.*impl='xla'"):
        fh.final_head_predict(x48, we48, g48, b48, wh48, patch_size=P)
    with pytest.raises(ValueError, match=r"\(K8\).*C % 32 == 0 and C <= 128.*impl='xla'"):
        fh.final_head_depth_loss_sums(x48, we48, g48, b48, wh48[:, :1], t, patch_size=P,
                                      loss_kind="l2")
    with pytest.raises(ValueError, match=r"\(K9\).*C % 32 == 0 and C <= 128.*impl='xla'"):
        fh.final_head_depth_loss_bwd(x48, we48, g48, b48, wh48, t, one, patch_size=P,
                                     loss_kind="nll")
    wide = torch.randn(C, 17)
    yw = torch.zeros(T, P, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(K6\).*F <= 16.*impl='xla'"):
        fh.final_head_loss_sums(x, we, g, b, wide, yw, w, patch_size=P)
    with pytest.raises(ValueError, match=r"\(K7\).*F <= 16.*impl='xla'"):
        fh.final_head_loss_bwd(x, we, g, b, wide, yw, w, one, patch_size=P)
    with pytest.raises(ValueError, match=r"\(K3\).*F <= 16.*impl='xla'"):
        fh.final_head_predict(x, we, g, b, wide, patch_size=P)
    assert dict(fh.launches) == before


@pytest.mark.parametrize("grid", GRIDS)
def test_f32_twins_at_the_paper_head_match_pallas(grid):
    """K6's partial rows and K7's two steps (the tile kernel's dx and partial rows,
    ``reduce_rows``), the twins of the f32 kernels' walk, in f32 at C 96, F 8, against the
    Pallas kernel in interpret mode and its VJP."""
    x, we, g, b, wh, y, w = (torch.from_numpy(a) for a in _operands())
    loss_j, cm_j, grads_j = _pallas()
    part = fh.final_head_loss_partials_plain(x, we, g, b, wh, y, w, patch_size=P, grid=grid)
    assert part.shape == (grid, 2 + F * F)
    red = fh.reduce_rows_plain(part)
    np.testing.assert_allclose(float(red[0] / red[1]), loss_j, rtol=LOSS_RTOL)
    np.testing.assert_array_equal(red[2:].reshape(F, F).numpy(), cm_j)
    scale = torch.tensor(SCALE) / red[1]
    dx, bpart = fh.final_head_loss_bwd_rows_f32_plain(x, we, g, b, wh, y, w, scale,
                                                      patch_size=P, grid=grid)
    assert dx.dtype == torch.float32
    assert bpart.shape == (grid, P * C * C + C * F + 2 * C)
    got = fh.final_head_loss_bwd_sequence_f32_plain(x, we, g, b, wh, y, w, scale,
                                                    patch_size=P, grid=grid)
    assert torch.equal(got[0], dx)
    for name, a, want in zip(("dx", "dwe", "dgamma", "dbeta", "dwh"), got, grads_j):
        _close(a, want, name)
    whole = fh.final_head_loss_bwd_plain(x, we, g, b, wh, y, w, scale, patch_size=P)
    for name, a, want in zip(("dx", "dwe", "dgamma", "dbeta", "dwh"), got, whole):
        _close(a, want, name)


def test_f32_loss_function_carries_f32_through_both_passes():
    """``final_head_loss`` on f32 operands (the plain versions on the CPU): the loss and
    confusion matrix of the plain K6, every gradient f32 and the plain K7's."""
    x, we, g, b, wh, y, w = (torch.from_numpy(a) for a in _operands())
    leaves = [t.clone().requires_grad_() for t in (x, we, g, b, wh)]
    loss, cm = fh.final_head_loss(*leaves, y, w, patch_size=P)
    num, den, wcm = fh.final_head_loss_plain(x, we, g, b, wh, y, w, patch_size=P)
    assert loss.dtype == torch.float32 and torch.equal(cm, wcm)
    assert torch.equal(loss.detach(), num / torch.clamp_min(den, 1e-12))
    (loss * SCALE).backward()
    want = fh.final_head_loss_bwd_plain(x, we, g, b, wh, y, w,
                                        torch.tensor(SCALE) / torch.clamp_min(den, 1e-12),
                                        patch_size=P)
    for leaf, wt in zip(leaves, (want[0], want[1], want[2], want[3], want[4])):
        assert leaf.grad.dtype == torch.float32
        torch.testing.assert_close(leaf.grad, wt, rtol=1e-6, atol=1e-7)
