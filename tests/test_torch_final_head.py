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
