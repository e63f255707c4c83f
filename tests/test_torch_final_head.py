"""heal_swin_torch decoder-tail predict (K3's plain version) against the Pallas
``fused_final_head_predict`` run in interpret mode on the CPU.

Indices must be equal outside near-ties (plain top-2 logits within 1e-5, where f32
sums taken in another order may reorder them).  In bfloat16 both sides round h and z
at the same points; the bf16 case runs 16384 sub-rows, enough that leaving out the
z rounding changes 23 indices outside the near-ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch.ops import final_head as fh
from heal_swin_tpu.ops.final_head import fused_final_head_predict

T, C, P, F = 256, 32, 4, 5
DTYPES = {"float32": (jnp.float32, torch.float32, T),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 4096)}


def _operands(seed, t=T):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(t, C)).astype(f),
            (rng.normal(size=(C, P * C)) * 0.2).astype(f),
            (1.0 + 0.3 * rng.normal(size=C)).astype(f),
            (0.2 * rng.normal(size=C)).astype(f),
            (rng.normal(size=(C, F)) * 0.3).astype(f))


def _near_ties(logits, gap=1e-5):
    """Rows whose top-2 logits lie within ``gap``: f32 products summed in another
    order (~1e-6 here) may reorder them."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) < gap


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_predict_plain_matches_pallas(dtype):
    """x, We and Wh in ``dtype`` (the compute dtype); LN params f32."""
    jdt, tdt, t = DTYPES[dtype]
    ops = _operands(0, t)
    x = ops[0].copy()
    x[3] = np.nan  # a diverged token: all its p sub-rows hold NaN logits -> F - 1
    in_dtype = (True, True, False, False, True)
    want = np.asarray(fused_final_head_predict(
        *[jnp.asarray(a, jdt if low else jnp.float32) for a, low in zip((x, *ops[1:]),
                                                                       in_dtype)],
        patch_size=P, interpret=True))
    tops = [torch.from_numpy(a).to(tdt if low else torch.float32)
            for a, low in zip((x, *ops[1:]), in_dtype)]
    got = fh.final_head_predict_plain(*tops, patch_size=P).numpy()
    assert got.shape == (t, P) and got.dtype == np.int32
    assert (got[3] == F - 1).all() and (want[3] == F - 1).all()
    logits = fh.final_head_logits_plain(*tops, patch_size=P).numpy()
    ok = ~_near_ties(logits)
    ok[3] = True
    np.testing.assert_array_equal(got[ok], want[ok])
    assert ok.mean() > 0.99


def test_argmax_lowest_ties_and_nan():
    lf = torch.tensor([[1.0, 3.0, 3.0, 0.0],  # tie -> lowest index
                       [float("nan"), 1.0, 2.0, 0.0],  # any NaN -> F - 1
                       [0.0, 1.0, float("nan"), 5.0],
                       [float("-inf")] * 4,  # all -inf -> 0
                       [0.0, float("inf"), 1.0, float("inf")]])
    assert fh.argmax_lowest(lf).tolist() == [1, 3, 3, 0, 1]


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_predict_wrapper_runs_plain_on_cpu(impl):
    ops = [torch.from_numpy(a) for a in _operands(1)]
    before, before_shapes = dict(fh.launches), fh.launches_by_shape.copy()
    got = fh.final_head_predict(*ops, patch_size=P, impl=impl)
    assert torch.equal(got, fh.final_head_predict_plain(*ops, patch_size=P))
    assert fh.launches == before and fh.launches_by_shape == before_shapes
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fh.final_head_predict(*ops, patch_size=P, impl="pallas")


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_predict_wrapper_taps_the_plain_logits_on_cpu(impl):
    """With ``tap_logits`` the wrapper gives the plain indices and the plain f32 logits
    (on the card the kernel's tap, which probe (h) holds the classes to), and
    ``argmax_lowest`` of the tap: F - 1 for a token holding a NaN; with gamma 0 and beta
    1 every z is 1, so logit f is C * Wh[0, f] exactly: 0 where all F tie below zero
    (the kernel's zero-padded head columns must not win there), the lowest index where
    columns 1.. tie above column 0."""
    x, we, g, b, wh = [torch.from_numpy(a) for a in _operands(2)]
    xn = x.clone()
    xn[7] = float("nan")
    before, before_shapes = dict(fh.launches), fh.launches_by_shape.copy()
    preds, lf = fh.final_head_predict(xn, we, g, b, wh, patch_size=P, impl=impl,
                                      tap_logits=True)
    assert torch.equal(preds, fh.final_head_predict_plain(xn, we, g, b, wh, patch_size=P))
    assert lf.dtype == torch.float32 and lf.shape == (T, P, F)
    want = fh.final_head_logits_plain(xn, we, g, b, wh, patch_size=P)
    assert torch.allclose(lf, want, rtol=0, atol=0, equal_nan=True) and lf[7].isnan().all()
    assert torch.equal(fh.argmax_lowest(lf), preds) and (preds[7] == F - 1).all()
    flat = (torch.zeros(C), torch.ones(C))
    for w0, want in ((-0.25, 0), (-0.5, 1)):
        head = torch.full((C, F), -0.25)
        head[:, 0] = w0
        preds, lf = fh.final_head_predict(x, we, *flat, head, patch_size=P, impl=impl,
                                          tap_logits=True)
        assert torch.equal(lf[..., 1:], torch.full((T, P, F - 1), -0.25 * C))
        assert (lf[..., 0] == w0 * C).all() and (preds == want).all()
    assert fh.launches == before and fh.launches_by_shape == before_shapes
