"""The f32 K4's and K17's launch sequences as their steps composed, on the CPU.

``chip_smoke.f32_bwd_steps`` composes the f32 K4 (cosine, with or without LayerNorm) and
the f32 K17 (cosine or scaled-dot) from their steps' own wrappers: qkv by
``gemm_nn_f32``, K4's o by the f32 K2, its projection / LayerNorm backward by
``qkv_epi_proj_ln_bwd``, dWp, do, dWqkv and dx by the wgmma core's ``gemm_wg_f32``, the
attention backward by the f32 K5 and dbqkv by ``reduce_rows``.  On the card the kernels
are held to it bit for bit; here every step runs its plain version, and the composition
is held to the plain K4 and K17 (f32, relative L2 1e-5 for every output), so that its
wiring (operand order, layouts, the outputs' order) is the kernels' own.
"""

import numpy as np
import pytest
import torch

from heal_swin_torch.ops import window_attention as wa

TOL = 1e-5
T, WS = 64 * 3, 64


def _operands(C, seed):
    """f32 operands at width C: tokens N(0, 1), weights at std C^-1/2, biases 0.02,
    LayerNorm near identity, rel-pos bias N(0, 0.5^2), 3 mask groups, logit scales near
    their init, dz N(0, 1)."""
    rng = np.random.default_rng(seed)
    h = C // 32

    def t(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))

    return (t(T, C), t(C, 3 * C, std=C ** -0.5), t(3 * C, std=0.02), t(C, C, std=C ** -0.5),
            t(C, std=0.02), 1 + t(C, std=0.1), t(C, std=0.1),
            torch.from_numpy(rng.integers(0, 3, (T // WS, WS)).astype(np.int32)),
            t(h, WS, WS, std=0.5), torch.exp(t(h, std=0.5) + 2.3), t(T, C))


def _close(got, want):
    assert len(got) == len(want)
    for u, w in zip(got, want):
        assert (u is None) == (w is None)
        if w is not None:
            assert u.shape == w.shape
            err = float(torch.linalg.vector_norm(u - w) / torch.linalg.vector_norm(w))
            assert err < TOL, err


@pytest.mark.parametrize("C", [64, 96])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("use_cos", [True, False])
def test_k17_steps_compose_to_the_plain_k17(C, masked, use_cos):
    import chip_smoke

    x, wq, bq, _, _, _, _, groups, bias, ls, dz = _operands(C, 10 + C + 2 * masked + use_cos)
    gr = groups if masked else None
    lsc = ls if use_cos else None
    kw = dict(ws=WS, num_heads=C // 32, use_cos=use_cos, sm_scale=32 ** -0.5, has_mask=masked)
    got = chip_smoke.f32_bwd_steps(x, wq, bq, None, None, None, gr, bias, lsc, dz, epi=False,
                                   impl="auto", **kw)
    _close(got, wa.window_attention_qkv_bwd_plain(x, wq, bq, gr, bias, lsc, dz, **kw))


@pytest.mark.parametrize("C", [64, 96])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("has_ln", [True, False])
def test_k4_steps_compose_to_the_plain_k4(C, masked, has_ln):
    import chip_smoke

    x, wq, bq, wp, bp, g, b, groups, bias, ls, dz = _operands(C, 20 + C + 2 * masked + has_ln)
    gr = groups if masked else None
    e = (x, wq, bq, wp, bp, g if has_ln else None, b if has_ln else None, gr, bias, ls)
    got = chip_smoke.f32_bwd_steps(*e[:6], gr, bias, ls, dz, num_heads=C // 32, use_cos=True,
                                   sm_scale=1.0, has_mask=masked, epi=True, impl="auto")
    _close(got, wa.window_attention_qkv_epi_bwd_plain(*e, dz, ws=WS, num_heads=C // 32,
                                                      sm_scale=1.0, has_mask=masked))
