"""heal_swin_torch CUDA kernels against their plain versions, on a GPU.

These tests skip without a CUDA device.  On a GPU host without JAX run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(the suite's conftest imports JAX).  Small shapes at the kernels' fixed geometry
(ws 64, head dim 32), bf16; tolerances as in chip_smoke.py: relative L2 1e-2 for
the attention kernels (the same roundings, another summation order), equal indices
outside near-ties for the decoder-tail kernel.
"""

import pytest
import torch

from heal_swin_torch.ops import final_head as fh
from heal_swin_torch.ops import window_attention as wa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _randn(gen, dev, *shape, std=1.0):
    return (torch.randn(*shape, generator=gen) * std).to(dev)


@pytest.mark.parametrize("C", [32, 96, 160, 384])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("has_ln", [False, True])
def test_qkv_epi_kernel(dev, C, masked, has_ln):
    gen = torch.Generator().manual_seed(C)
    h, T = C // 32, 64 * 32
    bf = torch.bfloat16
    x = _randn(gen, dev, T, C).to(bf)
    args = (x, _randn(gen, dev, C, 3 * C, std=C ** -0.5), _randn(gen, dev, 3 * C, std=0.02),
            _randn(gen, dev, C, C, std=C ** -0.5), _randn(gen, dev, C, std=0.02),
            1 + _randn(gen, dev, C, std=0.1) if has_ln else None,
            _randn(gen, dev, C, std=0.1) if has_ln else None,
            torch.randint(0, 3, (T // 64, 64), generator=gen, dtype=torch.int32).to(dev),
            _randn(gen, dev, h, 64, 64, std=0.5),
            torch.exp(_randn(gen, dev, h, std=0.5) + 2.3))
    kw = dict(ws=64, num_heads=h, sm_scale=32 ** -0.5, has_mask=masked)
    n = wa.launches["window_attention_qkv_epi"]
    key = ("window_attention_qkv_epi", T, C, masked)
    n_shape = wa.launches_by_shape[key]
    got = wa.window_attention_qkv_epi(*args, **kw)
    torch.cuda.synchronize()
    assert wa.launches["window_attention_qkv_epi"] == n + 1
    assert wa.launches_by_shape[key] == n_shape + 1
    assert _rel_l2(got, wa.window_attention_qkv_epi_plain(*args, **kw)) < 1e-2


@pytest.mark.parametrize("use_cos", [True, False])
def test_attention_kernel(dev, use_cos):
    gen = torch.Generator().manual_seed(1)
    C, h, T = 768, 24, 64 * 8
    qkv = _randn(gen, dev, T, 3 * C).to(torch.bfloat16)
    groups = torch.randint(0, 3, (T // 64, 64), generator=gen, dtype=torch.int32).to(dev)
    bias = _randn(gen, dev, h, 64, 64, std=0.5)
    ls = torch.exp(_randn(gen, dev, h, std=0.5) + 2.3) if use_cos else None
    kw = dict(ws=64, num_heads=h, use_cos=use_cos, sm_scale=32 ** -0.5)
    got = wa.window_attention(qkv, groups, bias, ls, **kw)
    torch.cuda.synchronize()
    assert _rel_l2(got, wa.window_attention_plain(qkv, groups, bias, ls, **kw)) < 1e-2


@pytest.mark.parametrize("C,F", [(96, 10), (32, 5)])
def test_final_head_kernel(dev, C, F):
    gen = torch.Generator().manual_seed(2)
    T, p = 64 * 64, 4
    x = _randn(gen, dev, T, C).to(torch.bfloat16)
    x[5] = float("nan")
    args = (x, _randn(gen, dev, C, p * C, std=0.02), 1 + _randn(gen, dev, C, std=0.1),
            _randn(gen, dev, C, std=0.1), _randn(gen, dev, C, F, std=0.3))
    n = fh.launches_by_shape[("final_head_predict", T, C)]
    got = fh.final_head_predict(*args, patch_size=p)
    torch.cuda.synchronize()
    assert fh.launches_by_shape[("final_head_predict", T, C)] == n + 1
    assert (got[5] == F - 1).all()
    logits = fh.final_head_logits_plain(*args, patch_size=p)
    top2 = logits.topk(2, dim=-1).values
    far = (top2[..., 0] - top2[..., 1]) > 0.05  # well outside bf16 rounding of z
    want = fh.argmax_lowest(logits)
    assert torch.equal(got[far], want[far]) and far.float().mean() > 0.5


def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros(64 * 2, 64, dtype=torch.bfloat16, device=dev)  # head dim 32, ws 64 ok
    w = torch.zeros(64, 192, device=dev)
    with pytest.raises(ValueError, match="ws=64"):
        wa.window_attention_qkv_epi(x, w, None, torch.zeros(64, 64, device=dev), None, None,
                                    None, None, None, torch.ones(2, device=dev), ws=16,
                                    num_heads=2, sm_scale=1.0, has_mask=False)
    with pytest.raises(ValueError, match="bfloat16"):
        wa.window_attention(torch.zeros(128, 192, device=dev), None, None,
                            torch.ones(2, device=dev), ws=64, num_heads=2, use_cos=True,
                            sm_scale=1.0, has_mask=False)
