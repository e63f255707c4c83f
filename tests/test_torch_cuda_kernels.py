"""heal_swin_torch CUDA kernels against their plain versions, on a GPU.

These tests skip without a CUDA device.  On a GPU host without JAX run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(the suite's conftest imports JAX).  Small shapes at the kernels' fixed geometry
(ws 64, head dim 32), bf16; tolerances as in chip_smoke.py: relative L2 1e-2 for
the attention kernels and every gradient (the same roundings, another summation
order), equal indices outside near-ties for the decoder-tail predict kernel, and for
the loss kernel the loss within 1e-3 relative and the confusion matrix off only by
near-tie rows.
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


@pytest.mark.parametrize("T", [64 * 64, 64 * 3])
@pytest.mark.parametrize("F", [5, 10, 17, 32])
@pytest.mark.parametrize("C", [32, 64, 96, 128])
def test_final_head_kernel(dev, C, F, T):
    """K3 at each instantiation of the row core (C 32 to 128; F <= 16 and <= 32), on a T
    whose last 128-row tile is full and on one whose last tile is half full: a NaN token
    gives F - 1 on each sub-pixel, the indices equal the plain version's outside
    near-ties, and the classes are ``argmax_lowest`` of the kernel's own f32 logits tap.
    With gamma 0 and beta 1 every z is 1, so logit f is C * Wh[0, f] exactly: where the F
    logits tie below zero the class is 0 (a zero-padded head column must not win), and
    where columns 1.. tie above column 0 it is 1."""
    gen = torch.Generator().manual_seed(2 + C + F)
    p = 4
    x = _randn(gen, dev, T, C).to(torch.bfloat16)
    x[5] = float("nan")
    args = (x, _randn(gen, dev, C, p * C, std=0.02), 1 + _randn(gen, dev, C, std=0.1),
            _randn(gen, dev, C, std=0.1), _randn(gen, dev, C, F, std=0.3))
    n = fh.launches_by_shape[("final_head_predict", T, C)]
    got = fh.final_head_predict(*args, patch_size=p)
    torch.cuda.synchronize()
    assert fh.launches_by_shape[("final_head_predict", T, C)] == n + 1
    assert got.shape == (T, p) and (got[5] == F - 1).all()
    logits = fh.final_head_logits_plain(*args, patch_size=p)
    top2 = logits.topk(2, dim=-1).values
    far = (top2[..., 0] - top2[..., 1]) > 0.05  # well outside bf16 rounding of z
    want = fh.argmax_lowest(logits)
    assert torch.equal(got[far], want[far]) and far.float().mean() > 0.5
    preds, tap = fh.final_head_predict(*args, patch_size=p, tap_logits=True)
    assert torch.equal(preds, got) and torch.equal(fh.argmax_lowest(tap), got)
    flat = (torch.zeros(C, device=dev), torch.ones(C, device=dev))
    for w0, cls in ((-0.25, 0), (-0.5, 1)):
        head = torch.full((C, F), -0.25, device=dev)
        head[:, 0] = w0
        preds, tap = fh.final_head_predict(x, args[1], *flat, head, patch_size=p,
                                           tap_logits=True)
        torch.cuda.synchronize()
        fine = torch.ones(T, dtype=torch.bool, device=dev)
        fine[5] = False
        assert (tap[fine, :, 1:] == -0.25 * C).all() and (tap[fine, :, 0] == w0 * C).all()
        assert (preds[fine] == cls).all() and (preds[5] == F - 1).all()


@pytest.mark.parametrize("T,C,F", [(64 * 65, 32, 20), (64 * 65, 96, 10), (64 * 65, 128, 32),
                                   (64 * 3, 64, 5)])
def test_final_head_predict_logits_are_the_loss_kernels(dev, T, C, F):
    """Probe (h): K3's classes are ``argmax_lowest`` of its own f32 logits tap, and that
    tap rounded to bf16 is K6's logits tap on the same operands, ``torch.equal`` (predict
    and the train loss make their logits through one function)."""
    gen = torch.Generator().manual_seed(40 + T + C + F)
    p = 4
    args = _loss_args(gen, dev, T, C, F, p)
    preds, lf3 = fh.final_head_predict(*args[:5], patch_size=p, tap_logits=True)
    lf6 = fh.final_head_loss_sums(*args, patch_size=p, tap_logits=True)[3]
    assert lf3.dtype == torch.float32 and int((lf3 != 0).sum()) > T * p * F // 2
    assert torch.equal(preds, fh.argmax_lowest(lf3))
    assert torch.equal(lf3.to(torch.bfloat16), lf6)


def _attn_args(gen, dev, C, T, use_cos):
    h = C // 32
    return (_randn(gen, dev, T, 3 * C).to(torch.bfloat16),
            torch.randint(0, 3, (T // 64, 64), generator=gen, dtype=torch.int32).to(dev),
            _randn(gen, dev, h, 64, 64, std=0.5),
            torch.exp(_randn(gen, dev, h, std=0.5) + 2.3) if use_cos else None)


@pytest.mark.parametrize("C,windows", [(768, 5), (96, 7), (160, 6), (768, 8)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("use_cos", [True, False])
def test_attention_kernel_tails_and_widths(dev, C, windows, masked, use_cos):
    """K2 where the window count is not a multiple of the windows one block walks (5, 7,
    6), at odd head counts (3, 5) and at the bottleneck width, masked and unmasked, in
    both flavours: within 1e-2 of the plain version, and a second launch bit-equal."""
    gen = torch.Generator().manual_seed(C + windows)
    T = 64 * windows
    qkv, groups, bias, ls = _attn_args(gen, dev, C, T, use_cos)
    args = (qkv, groups if masked else None, bias, ls)
    kw = dict(ws=64, num_heads=C // 32, use_cos=use_cos, sm_scale=32 ** -0.5, has_mask=masked)
    got = wa.window_attention(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel_l2(got, wa.window_attention_plain(*args, **kw)) < 1e-2
    assert torch.equal(got, wa.window_attention(*args, **kw))


def _edge_rows(dev, groups, bias):
    """Window 0: every token its own mask group, so each row keeps only its own key;
    window 1: two groups.  Row 5 of every head's bias is -1e30 everywhere, so its
    scores (mask included) round to one value and its probabilities are uniform."""
    groups[0] = torch.arange(64, dtype=torch.int32, device=dev)
    groups[1] = (torch.arange(64, device=dev) >= 32).to(torch.int32)
    bias[:, 5, :] = -1e30
    return groups, bias


@pytest.mark.parametrize("use_cos", [True, False])
def test_attention_kernel_edge_rows(dev, use_cos):
    """K2 on rows that keep a single key and on a row whose bias is very negative
    everywhere: finite and within 1e-2 of the plain version."""
    gen = torch.Generator().manual_seed(11)
    C, T = 96, 64 * 4
    qkv, groups, bias, ls = _attn_args(gen, dev, C, T, use_cos)
    groups, bias = _edge_rows(dev, groups, bias)
    kw = dict(ws=64, num_heads=C // 32, use_cos=use_cos, sm_scale=32 ** -0.5)
    got = wa.window_attention(qkv, groups, bias, ls, **kw)
    torch.cuda.synchronize()
    want = wa.window_attention_plain(qkv, groups, bias, ls, **kw)
    assert torch.isfinite(got.float()).all()
    assert _rel_l2(got, want) < 1e-2
    # a row alone in its group attends to itself (up to the other keys' e^-100 share),
    # but row 5, whose equal scores spread it over every key
    alone = torch.arange(64, device=dev) != 5
    assert _rel_l2(got[:64][alone], qkv[:64, 2 * C:][alone]) < 1e-2


def test_attention_kernel_probabilities_near_underflow(dev):
    """K2's bf16 probabilities, read through a v whose key c < 32 is the unit vector of
    channel c (so that o[:, c] is p[:, c] exactly), on rows whose biases fall from 0 to
    -100 across the keys: each within one bf16 ulp of bf16(e / d) computed in f32, down
    to bf16's subnormals (e near 2^-126, where the division's slow path runs) and at
    the e <= 2^-134 whose division the kernel skips."""
    gen = torch.Generator().manual_seed(13)
    T, nw = 64 * 4, 4
    qkv = _randn(gen, dev, T, 3 * 32).to(torch.bfloat16)
    v = torch.zeros(nw, 64, 32, device=dev)
    v[:, :32] = torch.eye(32, device=dev)
    qkv[:, 64:] = v.reshape(T, 32)
    ramp = torch.arange(64, device=dev)
    bias = (-100.0 / 63 * ((ramp[None, :] + ramp[:, None]) % 64)).reshape(1, 64, 64)
    kw = dict(ws=64, num_heads=1, use_cos=False, sm_scale=32 ** -0.5, has_mask=False)
    got = wa.window_attention(qkv, None, bias, None, **kw).reshape(nw, 64, 32).double()
    parts = qkv.reshape(nw, 64, 3, 1, 32).float()
    p = wa._softmax(wa._scores(parts[:, :, 0], parts[:, :, 1], None, bias, False, 32 ** -0.5))
    want = p.to(torch.bfloat16)[:, 0, :, :32].double()
    assert ((want > 0) & (want < 2.0 ** -126)).any() and (p[:, 0, :, :32] <= 2.0 ** -134).any()
    assert ((got - want).abs() <= 2.0 ** -7 * want.abs() + 2.0 ** -133).all()


@pytest.mark.parametrize("C", [32, 96, 160, 192, 384])
def test_qkv_epi_kernel_edge_rows_and_repeat(dev, C):
    """K1 (C 32: one head, the second core idle; 96, 160: odd head counts; 192, 384:
    one and two Wp column blocks per core) with the edge rows of K2's test, masked,
    with LayerNorm: within 1e-2 of the plain version, and a second launch bit-equal."""
    gen = torch.Generator().manual_seed(12 + C)
    T = 64 * 8
    x, wq, bq, wp, bp, g, b, groups, bias, ls = _epi_args(gen, dev, C, T, True, True)
    groups, bias = _edge_rows(dev, groups, bias)
    args = (x, wq, bq, wp, bp, g, b, groups, bias, ls)
    kw = dict(ws=64, num_heads=C // 32, sm_scale=32 ** -0.5, has_mask=True)
    got = wa.window_attention_qkv_epi(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel_l2(got, wa.window_attention_qkv_epi_plain(*args, **kw)) < 1e-2
    assert torch.equal(got, wa.window_attention_qkv_epi(*args, **kw))


def _epi_args(gen, dev, C, T, masked, has_ln):
    h = C // 32
    return (_randn(gen, dev, T, C).to(torch.bfloat16),
            _randn(gen, dev, C, 3 * C, std=C ** -0.5).to(torch.bfloat16),
            _randn(gen, dev, 3 * C, std=0.02).to(torch.bfloat16),
            _randn(gen, dev, C, C, std=C ** -0.5).to(torch.bfloat16),
            _randn(gen, dev, C, std=0.02).to(torch.bfloat16),
            1 + _randn(gen, dev, C, std=0.1) if has_ln else None,
            _randn(gen, dev, C, std=0.1) if has_ln else None,
            torch.randint(0, 3, (T // 64, 64), generator=gen, dtype=torch.int32).to(dev)
            if masked else None,
            _randn(gen, dev, h, 64, 64, std=0.5),
            torch.exp(_randn(gen, dev, h, std=0.5) + 2.3))


def _assert_grads_close(got, want, tol=1e-2):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, i
            continue
        assert torch.isfinite(g.float()).all(), i
        assert _rel_l2(g, w) < tol, (i, _rel_l2(g, w))


@pytest.mark.parametrize("C", [32, 96, 192, 384])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("has_ln", [False, True])
def test_qkv_epi_bwd_kernel(dev, C, masked, has_ln):
    """K4 against its plain version: dx and every parameter gradient."""
    gen = torch.Generator().manual_seed(10 + C)
    T = 64 * 16
    args = _epi_args(gen, dev, C, T, masked, has_ln)
    dz = _randn(gen, dev, T, C).to(torch.bfloat16)
    kw = dict(ws=64, num_heads=C // 32, sm_scale=32 ** -0.5, has_mask=masked)
    key = ("window_attention_qkv_epi_bwd", T, C, masked)
    n, n_shape = wa.launches["window_attention_qkv_epi_bwd"], wa.launches_by_shape[key]
    got = wa.window_attention_qkv_epi_bwd(*args, dz, **kw)
    torch.cuda.synchronize()
    assert wa.launches["window_attention_qkv_epi_bwd"] == n + 1
    assert wa.launches_by_shape[key] == n_shape + 1
    _assert_grads_close(got, wa.window_attention_qkv_epi_bwd_plain(*args, dz, **kw))
    # no float atomics: a second launch gives the same bits
    again = wa.window_attention_qkv_epi_bwd(*args, dz, **kw)
    assert all(g is None or torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("use_cos", [True, False])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("has_bias", [True, False])
def test_attention_bwd_kernel(dev, use_cos, masked, has_bias):
    """K5 against its plain version: dqkv, dbias, dlogit_scale."""
    gen = torch.Generator().manual_seed(3)
    C, h, T = 768, 24, 64 * 8
    qkv = _randn(gen, dev, T, 3 * C).to(torch.bfloat16)
    dout = _randn(gen, dev, T, C).to(torch.bfloat16)
    groups = torch.randint(0, 3, (T // 64, 64), generator=gen, dtype=torch.int32).to(dev)
    bias = _randn(gen, dev, h, 64, 64, std=0.5) if has_bias else None
    ls = torch.exp(_randn(gen, dev, h, std=0.5) + 2.3) if use_cos else None
    kw = dict(ws=64, num_heads=h, use_cos=use_cos, sm_scale=32 ** -0.5, has_mask=masked)
    n = wa.launches["window_attention_bwd"]
    got = wa.window_attention_bwd(qkv, groups if masked else None, bias, ls, dout, **kw)
    torch.cuda.synchronize()
    assert wa.launches["window_attention_bwd"] == n + 1
    want = wa.window_attention_bwd_plain(qkv, groups if masked else None, bias, ls, dout, **kw)
    _assert_grads_close(got, want)
    again = wa.window_attention_bwd(qkv, groups if masked else None, bias, ls, dout, **kw)
    assert all(g is None or torch.equal(g, a) for g, a in zip(got, again))


def test_attention_functions_backward_through_kernels(dev):
    """The autograd functions: forward K1/K2, backward K4/K5, each launched once."""
    gen = torch.Generator().manual_seed(4)
    C, T = 96, 64 * 8
    x, wq, bq, wp, bp, g, b, groups, bias, ls = _epi_args(gen, dev, C, T, True, True)
    leaves = [t.clone().requires_grad_() for t in (x, wq, wp, g, bias, ls)]
    kw = dict(ws=64, num_heads=C // 32, sm_scale=32 ** -0.5, has_mask=True)
    before = dict(wa.launches)
    out = wa.window_attention_qkv_epi(leaves[0], leaves[1], bq, leaves[2], bp, leaves[3], b,
                                      groups, leaves[4], leaves[5], **kw)
    qkv = out.repeat(1, 3)
    out2 = wa.window_attention(qkv, groups, None, ls[:3].contiguous(), ws=64, num_heads=3,
                               use_cos=True, sm_scale=1.0)
    out2.float().square().sum().backward()
    torch.cuda.synchronize()
    for k in ("window_attention_qkv_epi", "window_attention", "window_attention_bwd",
              "window_attention_qkv_epi_bwd"):
        assert wa.launches[k] == before[k] + 1, k
    for t in leaves:
        assert t.grad is not None and t.grad.dtype == t.dtype
        assert torch.isfinite(t.grad.float()).all()


def _loss_args(gen, dev, T, C, F, p=4):
    x = _randn(gen, dev, T, C).to(torch.bfloat16)
    return (x, _randn(gen, dev, C, p * C, std=0.1), 1 + _randn(gen, dev, C, std=0.1),
            _randn(gen, dev, C, std=0.1), _randn(gen, dev, C, F, std=0.3),
            torch.randint(0, F, (T, p), generator=gen, dtype=torch.int32).to(dev),
            torch.rand(T, p, generator=gen).to(dev) + 0.5)


def _near_tie_rows(args, p=4):
    """Sub-rows whose top-2 bf16 logits lie within two bf16 steps of the larger one."""
    lf = fh.final_head_logits_plain(*args[:5], patch_size=p).to(torch.bfloat16).float()
    top2 = lf.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) <= 2 * 2.0 ** -7 * top2[..., 0].abs()


@pytest.mark.parametrize("C,F", [(96, 10), (32, 5)])
def test_final_head_loss_kernels(dev, C, F):
    """K6 (loss, confusion matrix) and K7 (every gradient) against their plain
    versions; a NaN token counts in no cell."""
    gen = torch.Generator().manual_seed(5)
    T, p = 64 * 64, 4
    args = _loss_args(gen, dev, T, C, F)
    n6, n7 = fh.launches["final_head_loss"], fh.launches["final_head_loss_bwd"]
    num, den, cm = fh.final_head_loss_sums(*args, patch_size=p)
    torch.cuda.synchronize()
    wnum, wden, wcm = fh.final_head_loss_plain(*args, patch_size=p)
    assert abs(float(num / den) - float(wnum / wden)) <= 1e-3 * abs(float(wnum / wden))
    assert float(cm.sum()) == T * p
    assert float((cm - wcm).abs().sum()) <= 2 * int(_near_tie_rows(args).sum())
    scale = torch.tensor(1.3, device=dev) / wden
    got = fh.final_head_loss_bwd(*args, scale, patch_size=p)
    torch.cuda.synchronize()
    assert fh.launches["final_head_loss"] == n6 + 1
    assert fh.launches["final_head_loss_bwd"] == n7 + 1
    _assert_grads_close(got, fh.final_head_loss_bwd_plain(*args, scale, patch_size=p))
    again = fh.final_head_loss_bwd(*args, scale, patch_size=p)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert torch.equal(num, fh.final_head_loss_sums(*args, patch_size=p)[0])

    nan_args = (args[0].clone(),) + args[1:]
    nan_args[0][5] = float("nan")
    _, _, cm_nan = fh.final_head_loss_sums(*nan_args, patch_size=p)
    assert float(cm_nan.sum()) == T * p - p  # token 5's p sub-pixels count nowhere


def test_final_head_loss_function_backward_through_kernels(dev):
    gen = torch.Generator().manual_seed(6)
    args = list(_loss_args(gen, dev, 64 * 16, 96, 10))
    for i in range(5):
        args[i] = args[i].clone().requires_grad_()
    before = dict(fh.launches)
    loss, cm = fh.final_head_loss(*args, patch_size=4)
    loss.backward()
    torch.cuda.synchronize()
    assert fh.launches["final_head_loss"] == before["final_head_loss"] + 1
    assert fh.launches["final_head_loss_bwd"] == before["final_head_loss_bwd"] + 1
    assert not cm.requires_grad and float(cm.sum()) == 64 * 16 * 4
    for t in args[:5]:
        assert t.grad is not None and t.grad.dtype == t.dtype


@pytest.mark.parametrize("C,F,p", [(32, 10, 4), (64, 20, 4), (96, 32, 4), (128, 10, 4),
                                   (128, 16, 2)])
def test_final_head_loss_kernels_at_every_width(dev, C, F, p):
    """K6 at each of its instantiations (C 32 to 128, F <= 16 and <= 32) on a T whose
    last 128-row tile is half full, against its plain version; K7 (two launches
    bit-equal) wherever its shared memory holds the p slices, which at C 128 takes p 2
    (``test_tail_kernels_refuse_what_their_shared_memory_does_not_hold``)."""
    gen = torch.Generator().manual_seed(C + F + p)
    T = 64 * 65
    args = _loss_args(gen, dev, T, C, F, p)
    num, den, cm = fh.final_head_loss_sums(*args, patch_size=p)
    torch.cuda.synchronize()
    wnum, wden, wcm = fh.final_head_loss_plain(*args, patch_size=p)
    assert abs(float(num / den) - float(wnum / wden)) <= 1e-3 * abs(float(wnum / wden))
    assert float(cm.sum()) == T * p
    assert float((cm - wcm).abs().sum()) <= 2 * int(_near_tie_rows(args, p).sum())
    if (C, p) == (128, 4):
        return
    scale = torch.tensor(0.7, device=dev) / wden
    got = fh.final_head_loss_bwd(*args, scale, patch_size=p)
    _assert_grads_close(got, fh.final_head_loss_bwd_plain(*args, scale, patch_size=p))
    again = fh.final_head_loss_bwd(*args, scale, patch_size=p)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_final_head_loss_kernels_at_the_paper_tail(dev):
    """K6 and K7 at the paper tail (T 262,144, C 96, p 4, F 10) against their plain
    versions: the loss within 1e-3 relative, the confusion matrix off only at near-ties,
    every gradient within relative L2 1e-2."""
    gen = torch.Generator().manual_seed(21)
    T, C, F, p = 262144, 96, 10, 4
    args = _loss_args(gen, dev, T, C, F, p)
    num, den, cm = fh.final_head_loss_sums(*args, patch_size=p)
    wnum, wden, wcm = fh.final_head_loss_plain(*args, patch_size=p)
    assert abs(float(num / den) - float(wnum / wden)) <= 1e-3 * abs(float(wnum / wden))
    assert float(cm.sum()) == T * p
    assert float((cm - wcm).abs().sum()) <= 2 * int(_near_tie_rows(args, p).sum())
    scale = torch.tensor(1.0, device=dev) / wden
    _assert_grads_close(fh.final_head_loss_bwd(*args, scale, patch_size=p),
                        fh.final_head_loss_bwd_plain(*args, scale, patch_size=p))


@pytest.mark.parametrize("T,C,F", [(64 * 65, 96, 10), (64 * 33, 32, 20), (262144, 96, 10)])
def test_final_head_loss_bwd_sequence_kernels(dev, T, C, F):
    """Each step of K7's launch sequence against its plain twin: the row kernel (dx, dh,
    the partial rows on its grid), ``gemm_tn`` (dWe = x^T dh) and ``reduce_rows``, each
    on the kernel's own input; and K7 is the three steps composed, bit for bit."""
    gen = torch.Generator().manual_seed(T + C + F)
    p = 4
    args = _loss_args(gen, dev, T, C, F, p)
    scale = torch.tensor(1.3, device=dev) / args[6].sum()
    dx, dh, part = fh.final_head_loss_bwd_rows(*args, scale, patch_size=p)
    grid = part.shape[0]
    assert 1 <= grid <= -(-T // fh.TAIL_TILE_ROWS)
    _assert_grads_close((dx, dh, part), fh.final_head_loss_bwd_rows_plain(
        *args, scale, patch_size=p, grid=grid))
    dwe = fh.final_head_loss_dwe(args[0], dh)
    _assert_grads_close((dwe,), (fh.final_head_loss_dwe_plain(args[0], dh),), tol=1e-5)
    red = fh.reduce_rows(part)
    _assert_grads_close((red,), (fh.reduce_rows_plain(part),), tol=1e-5)
    dwh, dg, db = red.split([C * F, C, C])
    whole = fh.final_head_loss_bwd(*args, scale, patch_size=p)
    assert all(torch.equal(a, b) for a, b in zip(whole, (dx, dwe, dg, db, dwh.reshape(C, F))))


@pytest.mark.parametrize("T,C,F", [(64 * 65, 32, 20), (64 * 65, 96, 10), (262144, 96, 10)])
def test_final_head_loss_bwd_recomputes_the_forward_logits(dev, T, C, F):
    """K7's row kernel recomputes K6's rounded logits bit for bit: both kernels' logits
    taps, ``torch.equal``; both near the plain version's."""
    gen = torch.Generator().manual_seed(T + C)
    p = 4
    args = _loss_args(gen, dev, T, C, F, p)
    lf6 = fh.final_head_loss_sums(*args, patch_size=p, tap_logits=True)[3]
    lf7 = fh.final_head_loss_bwd_rows(*args, torch.tensor(1.0, device=dev), patch_size=p,
                                      tap_logits=True)[3]
    assert lf6.shape == (T, p, F) and int((lf6 != 0).sum()) > T * p * F // 2
    assert torch.equal(lf6, lf7)
    assert _rel_l2(lf6, fh.final_head_logits_plain(*args[:5], patch_size=p)) < 1e-2


def test_loss_kernels_refuse_widths_without_an_instantiation(dev):
    """K6 and K7, and K3 on their row core, hold a row in mma accumulators, one
    instantiation per C in 32, 64, 96, 128: other widths the tails took before (C % 16)
    raise, naming impl="xla", with no launch."""
    gen = torch.Generator().manual_seed(14)
    one = torch.ones((), device=dev)
    for C in (48, 80, 112):
        args = _loss_args(gen, dev, 128, C, 10)
        before = dict(fh.launches)
        with pytest.raises(ValueError, match="C % 32 == 0 and C <= 128.*impl='xla'"):
            fh.final_head_loss_sums(*args, patch_size=4)
        with pytest.raises(ValueError, match="C % 32 == 0 and C <= 128.*impl='xla'"):
            fh.final_head_loss_bwd(*args, one, patch_size=4)
        with pytest.raises(ValueError, match="C % 32 == 0 and C <= 128.*impl='xla'"):
            fh.final_head_predict(*args[:5], patch_size=4)
        assert dict(fh.launches) == before


def test_kernels_refuse_what_they_do_not_take(dev):
    """On CUDA tensors the wrappers raise on operands their kernels do not take, under
    "auto" as under "pallas", naming impl="xla" as the plain route."""
    x = torch.zeros(64 * 2, 64, dtype=torch.bfloat16, device=dev)  # head dim 32, ws 64 ok
    w = torch.zeros(64, 192, device=dev)
    C = 448
    xb = torch.zeros(128, C, dtype=torch.bfloat16, device=dev)
    gen = torch.Generator().manual_seed(7)
    wide = _loss_args(gen, dev, 128, 160, 10)
    many = _loss_args(gen, dev, 128, 32, 40)
    few = _loss_args(gen, dev, 128, 32, 5)
    for impl in ("auto", "pallas"):
        P = dict(impl=impl)
        with pytest.raises(ValueError, match="ws=64.*impl='xla'"):
            wa.window_attention_qkv_epi(x, w, None, torch.zeros(64, 64, device=dev), None,
                                        None, None, None, None, torch.ones(2, device=dev),
                                        ws=16, num_heads=2, sm_scale=1.0, has_mask=False, **P)
        with pytest.raises(ValueError, match="K5 takes bfloat16"):
            wa.window_attention(torch.zeros(128, 192, device=dev, requires_grad=True), None,
                                None, torch.ones(2, device=dev), ws=64, num_heads=2,
                                use_cos=True, sm_scale=1.0, has_mask=False, **P)
        with pytest.raises(ValueError, match="C <= 384"):
            wa.window_attention_qkv_epi_bwd(xb, torch.zeros(C, 3 * C, device=dev), None,
                                            torch.zeros(C, C, device=dev), None, None, None,
                                            None, None, torch.ones(C // 32, device=dev), xb,
                                            ws=64, num_heads=C // 32, sm_scale=1.0,
                                            has_mask=False, **P)
        with pytest.raises(ValueError, match="C <= 384"):
            wa.window_attention_qkv_fwd(xb, torch.zeros(C, 3 * C, device=dev), None, None,
                                        None, None, ws=64, num_heads=C // 32, use_cos=False,
                                        sm_scale=1.0, has_mask=False, **P)
        with pytest.raises(ValueError, match="head dim 32"):
            wa.window_attention_qkv_bwd(x, w, None, None, None, None, x, ws=64, num_heads=4,
                                        use_cos=False, sm_scale=1.0, has_mask=False, **P)
        with pytest.raises(ValueError, match="dout"):
            wa.window_attention_bwd(torch.zeros(128, 192, dtype=torch.bfloat16, device=dev),
                                    None, None, torch.ones(2, device=dev),
                                    torch.zeros(128, 64, device=dev), ws=64, num_heads=2,
                                    use_cos=True, sm_scale=1.0, has_mask=False, **P)
        with pytest.raises(ValueError, match="C <= 128"):
            fh.final_head_loss_bwd(*wide, torch.ones((), device=dev), patch_size=4, **P)
        with pytest.raises(ValueError, match="F <= 32"):
            fh.final_head_loss_sums(*many, patch_size=4, **P)
        with pytest.raises(ValueError, match=r"\(K3\).*F <= 16.*impl='xla'"):
            fh.final_head_predict(many[0].float(), *many[1:5], patch_size=4, **P)


def test_auto_refuses_what_the_kernels_do_not_take(dev):
    """Under "auto" a CUDA tensor that the kernels were not written for (float32 where
    the kernel has no f32 variant -- K16 --, or needs a gradient -- K2, whose backward
    K5 has none --, an f32 tail at a width without an instantiation, the window 16)
    raises with no launch, naming impl="xla", which runs the plain version: no launch,
    and bit for bit the plain version's result.  (K3 and K6-K9 take float32 since
    their f32 kernels, K1 and K2 for the forward alone: ``test_final_head_loss_f32_kernels``,
    ``test_final_head_depth_loss_f32_kernels``, ``test_window_attention_f32_kernels``.)"""
    gen = torch.Generator().manual_seed(12)
    C, T, h = 64, 64 * 4, 2
    x = _randn(gen, dev, T, C)
    wq, bq = _randn(gen, dev, C, 3 * C, std=0.1), _randn(gen, dev, 3 * C, std=0.1)
    groups = torch.randint(0, 3, (T // 16, 16), generator=gen, dtype=torch.int32).to(dev)
    bias16 = _randn(gen, dev, h, 16, 16)
    ls = torch.exp(_randn(gen, dev, h, std=0.5) + 2.3)
    tail48 = _loss_args_f32(gen, dev, T, 48, 10)
    depth48 = _depth_args_f32(gen, dev, T, 48, 1)
    cases = [
        (wa.window_attention_qkv_fwd, wa.window_attention_qkv_plain,
         (x, wq, bq, None, None, None),
         dict(ws=64, num_heads=h, use_cos=False, sm_scale=0.2, has_mask=False)),
        (wa.window_attention_qkv_fwd, wa.window_attention_qkv_plain,
         (x.bfloat16(), wq, bq, groups, bias16, ls),
         dict(ws=16, num_heads=h, use_cos=True, sm_scale=0.2)),
        (wa.window_attention_qkv_bwd, wa.window_attention_qkv_bwd_plain,
         (x, wq, bq, None, None, None, x),
         dict(ws=64, num_heads=h, use_cos=False, sm_scale=0.2, has_mask=False)),
        (wa.window_attention_fwd, wa.window_attention_plain,
         ((x @ wq).detach().requires_grad_(), None, None, ls),
         dict(ws=64, num_heads=h, use_cos=True, sm_scale=0.2, has_mask=False)),
        (wa.window_attention_qkv_epi_fwd, wa.window_attention_qkv_epi_plain,
         (x.bfloat16(), wq, bq, wq[:, :C], bq[:C], None, None, groups, bias16, ls),
         dict(ws=16, num_heads=h, sm_scale=0.2)),
        (fh.final_head_predict, fh.final_head_predict_plain, tail48[:5], dict(patch_size=4)),
        (fh.final_head_depth_loss_sums, fh.final_head_depth_loss_plain, depth48,
         dict(patch_size=4, loss_kind="l2")),
    ]
    for fn, plain, args, kw in cases:
        before = (dict(wa.launches), dict(fh.launches))
        with pytest.raises(ValueError, match="impl='xla'"):
            fn(*args, **kw)
        got = fn(*args, **kw, impl="xla")
        torch.cuda.synchronize()
        assert (dict(wa.launches), dict(fh.launches)) == before, fn.__name__
        want = plain(*args, **kw)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        assert all((g is None and w_ is None) or torch.equal(g, w_) for g, w_ in zip(got, want))


def test_tail_kernels_refuse_what_their_shared_memory_does_not_hold(dev):
    """The tail wrappers read the shared memory a block asks for from the library: K7
    at C 128 with four sub-pixels (its z and dlogits tiles) needs more than a block may
    have and raises; K3 at C 160 is refused by the row core's width rule, naming
    impl="xla"; K3 at C 128 with four sub-pixels launches, and so does K9 (no tile of
    its own beside the slices and the x ring), within 1e-2 of its plain version."""
    gen = torch.Generator().manual_seed(13)
    one = torch.ones((), device=dev)
    loss128 = _loss_args(gen, dev, 128, 128, 10)
    with pytest.raises(ValueError, match="shared memory.*impl='xla'"):
        fh.final_head_loss_bwd(*loss128, one, patch_size=4)
    with pytest.raises(ValueError, match="C <= 128.*impl='xla'"):
        fh.final_head_predict(*_loss_args(gen, dev, 128, 160, 10)[:5], patch_size=4)
    before = dict(fh.launches)
    fh.final_head_predict(*loss128[:5], patch_size=4)
    dargs = _depth_args(gen, dev, 128, 128, 1)
    got = fh.final_head_depth_loss_bwd(*dargs, one, patch_size=4, loss_kind="l2")
    torch.cuda.synchronize()
    assert fh.launches["final_head_predict"] == before["final_head_predict"] + 1
    assert (fh.launches["final_head_depth_loss_bwd"]
            == before["final_head_depth_loss_bwd"] + 1)
    _assert_grads_close(got, fh.final_head_depth_loss_bwd_plain(*dargs, one, patch_size=4,
                                                                loss_kind="l2"))


def _qkv_args(gen, dev, C, T, masked, use_cos, qkv_bias):
    h = C // 32
    return (_randn(gen, dev, T, C).to(torch.bfloat16),
            _randn(gen, dev, C, 3 * C, std=C ** -0.5).to(torch.bfloat16),
            _randn(gen, dev, 3 * C, std=0.1).to(torch.bfloat16) if qkv_bias else None,
            torch.randint(0, 3, (T // 64, 64), generator=gen, dtype=torch.int32).to(dev)
            if masked else None,
            _randn(gen, dev, h, 64, 64, std=0.5),
            torch.exp(_randn(gen, dev, h, std=0.5) + 2.3) if use_cos else None)


@pytest.mark.parametrize("C", [32, 96, 192, 384])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("use_cos", [False, True])
@pytest.mark.parametrize("qkv_bias", [True, False])
@pytest.mark.parametrize("windows", [16, 21])
def test_qkv_kernels(dev, C, masked, use_cos, qkv_bias, windows):
    """K16 and K17 against their plain versions: the output, dx and every parameter
    gradient; a second K17 launch gives the same bits (no float atomics).  21 windows
    leave K17's last run of 8 windows 5 long."""
    gen = torch.Generator().manual_seed(20 + C + windows)
    T = 64 * windows
    args = _qkv_args(gen, dev, C, T, masked, use_cos, qkv_bias)
    dout = _randn(gen, dev, T, C).to(torch.bfloat16)
    kw = dict(ws=64, num_heads=C // 32, use_cos=use_cos, sm_scale=32 ** -0.5,
              has_mask=masked)
    before = dict(wa.launches)
    key = ("window_attention_qkv", T, C, masked)
    n_shape = wa.launches_by_shape[key]
    got = wa.window_attention_qkv_fwd(*args, **kw)
    grads = wa.window_attention_qkv_bwd(*args, dout, **kw)
    torch.cuda.synchronize()
    assert wa.launches["window_attention_qkv"] == before["window_attention_qkv"] + 1
    assert wa.launches["window_attention_qkv_bwd"] == before["window_attention_qkv_bwd"] + 1
    assert wa.launches_by_shape[key] == n_shape + 1
    assert _rel_l2(got, wa.window_attention_qkv_plain(*args, **kw)) < 1e-2
    want = wa.window_attention_qkv_bwd_plain(*args, dout, **kw)
    _assert_grads_close(grads[:2] + grads[3:], want[:2] + want[3:])
    if qkv_bias:
        _assert_grads_close(grads[2:3], want[2:3])
    again = wa.window_attention_qkv_bwd(*args, dout, **kw)
    assert all(g is None or torch.equal(g, a) for g, a in zip(grads, again))


@pytest.mark.parametrize("C", [32, 96, 160])
@pytest.mark.parametrize("use_cos", [False, True])
def test_qkv_kernels_edge_rows(dev, C, use_cos):
    """K16 and K17 with the edge rows of K2's test (rows alone in their mask group, a
    row whose bias is -1e30 everywhere), masked: finite, within 1e-2 of the plain
    versions, and second launches bit-equal."""
    gen = torch.Generator().manual_seed(30 + C)
    T = 64 * 4
    x, wq, bq, groups, bias, ls = _qkv_args(gen, dev, C, T, True, use_cos, True)
    groups, bias = _edge_rows(dev, groups, bias)
    args = (x, wq, bq, groups, bias, ls)
    dout = _randn(gen, dev, T, C).to(torch.bfloat16)
    kw = dict(ws=64, num_heads=C // 32, use_cos=use_cos, sm_scale=32 ** -0.5, has_mask=True)
    got = wa.window_attention_qkv_fwd(*args, **kw)
    grads = wa.window_attention_qkv_bwd(*args, dout, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel_l2(got, wa.window_attention_qkv_plain(*args, **kw)) < 1e-2
    _assert_grads_close(grads, wa.window_attention_qkv_bwd_plain(*args, dout, **kw))
    assert torch.equal(got, wa.window_attention_qkv_fwd(*args, **kw))
    again = wa.window_attention_qkv_bwd(*args, dout, **kw)
    assert all(g is None or torch.equal(g, a) for g, a in zip(grads, again))


def _probe_v(dev, T, C, gen, std):
    """x (T, C) whose channel r < 32 is one-hot on row r of each window's first 32 rows
    (rows 32-63 zero there), its other channels random; Wqkv (C, 3C) random but for head
    0's v columns, [I_32; 0]; so head 0's v rows are e_r for keys r < 32 and 0 beyond, and
    K16's o[i, c] is bf16(P[i, key c])."""
    bf = torch.bfloat16
    x = _randn(gen, dev, T, C, std=std)
    x.view(T // 64, 64, C)[:, :, :32] = 0
    x.view(T // 64, 64, C)[:, :32, :32] = torch.eye(32, device=dev)
    wq = _randn(gen, dev, C, 3 * C, std=C ** -0.5)
    wq[:, 2 * C:2 * C + 32] = 0
    wq[:32, 2 * C:2 * C + 32] = torch.eye(32, device=dev)
    return x.to(bf), wq.to(bf)


def _probe_dout(dev, T, C):
    """dout whose head-0 columns are one-hot on each window's rows: dO[i, c] = (i == c),
    so that K17's dv[key, c] = bf16(P[c, key]), and with x of ``_probe_v`` on one
    window dWqkv[key, 2C + c] = dv[key, c] for key < 32."""
    dout = torch.zeros(T, C, device=dev)
    dout.view(T // 64, 64, C)[:, :32, :32] = torch.eye(32, device=dev)
    return dout.to(torch.bfloat16)


@pytest.mark.parametrize("use_cos", [False, True])
def test_qkv_bwd_recomputes_the_forward_probabilities(dev, use_cos):
    """K17 recomputes K16's probabilities bit for bit (one window, C 96, masked): K16's
    o[c, key] = bf16(P[c, key]) through head 0's v = e_key, and K17's dWqkv[key, 2C + c] =
    dv[key, c] = bf16(P[c, key]) through dO[i, c] = (i == c), for queries c and keys < 32."""
    gen = torch.Generator().manual_seed(40 + use_cos)
    C, T = 96, 64
    x, wq = _probe_v(dev, T, C, gen, 1.0)
    bq = _randn(gen, dev, 3 * C, std=0.1).to(torch.bfloat16)
    bq[2 * C:] = 0
    groups = torch.randint(0, 3, (1, 64), generator=gen, dtype=torch.int32).to(dev)
    bias = _randn(gen, dev, 3, 64, 64, std=0.5)
    ls = torch.exp(_randn(gen, dev, 3, std=0.5) + 2.3) if use_cos else None
    kw = dict(ws=64, num_heads=3, use_cos=use_cos, sm_scale=32 ** -0.5, has_mask=True)
    args = (x, wq, bq, groups, bias, ls)
    o = wa.window_attention_qkv_fwd(*args, **kw)
    _, dwq, *_ = wa.window_attention_qkv_bwd(*args, _probe_dout(dev, T, C), **kw)
    torch.cuda.synchronize()
    p_fwd = o[:32, :32].float()
    p_bwd = dwq[:32, 2 * C:2 * C + 32].t()
    assert (p_fwd > 0).sum() > 256  # the probe reads real probabilities
    assert torch.equal(p_fwd, p_bwd)


@pytest.mark.parametrize("C", [96, 192, 384])
def test_qkv_epi_with_identity_projection_is_k16_cosine(dev, C):
    """K1 with Wp = I, bp = 0 and no LayerNorm gives K16's cosine output bit for bit
    (8 windows, masked; one Wp column block per core at C 96 and 192, two at C 384):
    both run one head loop, so K4's launch sequence, which recomputes o with K16,
    starts from K1's o."""
    gen = torch.Generator().manual_seed(60 + C)
    x, wq, bq, groups, bias, ls = _qkv_args(gen, dev, C, 64 * 8, True, True, True)
    eye = torch.eye(C, device=dev, dtype=torch.bfloat16)
    kw = dict(ws=64, num_heads=C // 32, sm_scale=32 ** -0.5, has_mask=True)
    k1 = wa.window_attention_qkv_epi_fwd(x, wq, bq, eye, None, None, None, groups, bias, ls,
                                         **kw)
    k16 = wa.window_attention_qkv_fwd(x, wq, bq, groups, bias, ls, use_cos=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k1, k16)


@pytest.mark.parametrize("C", [96, 384])
def test_qkv_epi_bwd_recomputes_the_forward_probabilities(dev, C):
    """K4 recomputes K1's probabilities bit for bit (one window, masked): with Wp = I,
    bp = 0 and no LayerNorm K1's output is o, whose o[i, c] = bf16(P[i, key c]) through
    head 0's v = e_key (``_probe_v``); with dz one-hot on head 0 (``_probe_dout``) du =
    dz and do = du Wp^T = dz, so K4's dWqkv[key, 2C + c] = dv[key, c] = bf16(P[c, key])."""
    gen = torch.Generator().manual_seed(70 + C)
    T, h = 64, C // 32
    x, wq = _probe_v(dev, T, C, gen, 1.0)
    bq = _randn(gen, dev, 3 * C, std=0.1).to(torch.bfloat16)
    bq[2 * C:] = 0
    groups = torch.randint(0, 3, (1, 64), generator=gen, dtype=torch.int32).to(dev)
    bias = _randn(gen, dev, h, 64, 64, std=0.5)
    ls = torch.exp(_randn(gen, dev, h, std=0.5) + 2.3)
    eye = torch.eye(C, device=dev, dtype=torch.bfloat16)
    args = (x, wq, bq, eye, None, None, None, groups, bias, ls)
    kw = dict(ws=64, num_heads=h, sm_scale=32 ** -0.5, has_mask=True)
    o = wa.window_attention_qkv_epi_fwd(*args, **kw)
    dwq = wa.window_attention_qkv_epi_bwd(*args, _probe_dout(dev, T, C), **kw)[1]
    torch.cuda.synchronize()
    p_fwd = o[:32, :32].float()
    p_bwd = dwq[:32, 2 * C:2 * C + 32].t()
    assert (p_fwd > 0).sum() > 256  # the probe reads real probabilities
    assert torch.equal(p_fwd, p_bwd)


@pytest.mark.parametrize("use_cos", [False, True])
def test_attention_bwd_recomputes_the_forward_probabilities(dev, use_cos):
    """K5 recomputes K2's probabilities bit for bit (C 768, 24 heads, 8 windows,
    masked): with head 0's v rows e_key for keys < 32 and 0 beyond, K2's o[i, c] =
    bf16(P[i, key c]); with dout one-hot on head 0 (``_probe_dout``), K5's dv[key, c] =
    bf16(P[c, key]), window by window."""
    gen = torch.Generator().manual_seed(80 + use_cos)
    C, h, nw = 768, 24, 8
    T = 64 * nw
    qkv, groups, bias, ls = _attn_args(gen, dev, C, T, use_cos)
    v = qkv.view(nw, 64, 3 * C)[:, :, 2 * C:2 * C + 32]
    v.zero_()
    v[:, :32] = torch.eye(32, device=dev, dtype=torch.bfloat16)
    kw = dict(ws=64, num_heads=h, use_cos=use_cos, sm_scale=32 ** -0.5, has_mask=True)
    o = wa.window_attention_fwd(qkv, groups, bias, ls, **kw)
    dqkv = wa.window_attention_bwd(qkv, groups, bias, ls, _probe_dout(dev, T, C), **kw)[0]
    torch.cuda.synchronize()
    p_fwd = o.view(nw, 64, C)[:, :32, :32].float()
    p_bwd = dqkv.view(nw, 64, 3 * C)[:, :32, 2 * C:2 * C + 32].transpose(1, 2).float()
    assert (p_fwd > 0).sum() > 256 * nw
    assert torch.equal(p_fwd, p_bwd)


@pytest.mark.parametrize("T,C", [(262144, 96), (65536, 192), (16384, 384)])
@pytest.mark.parametrize("has_ln", [True, False])
def test_proj_ln_bwd_kernel(dev, T, C, has_ln):
    """K4's projection/LayerNorm backward alone (``qkv_epi_proj_ln_bwd``) against its
    plain version at the three stage shapes: du, dbp, dgamma, dbeta within relative L2
    1e-3 (one product and the LayerNorm's f32 sums in another order, du rounded to
    bf16); without LayerNorm du is dz and dbp its column sums.  A second launch gives
    the same bits."""
    gen = torch.Generator().manual_seed(90 + C)
    o = _randn(gen, dev, T, C).to(torch.bfloat16)
    wp = _randn(gen, dev, C, C, std=C ** -0.5).to(torch.bfloat16)
    bp = _randn(gen, dev, C, std=0.02).to(torch.bfloat16)
    g = 1 + _randn(gen, dev, C, std=0.1) if has_ln else None
    dz = _randn(gen, dev, T, C).to(torch.bfloat16)
    got = wa.qkv_epi_proj_ln_bwd(o, wp, bp, g, dz)
    torch.cuda.synchronize()
    _assert_grads_close(got, wa.qkv_epi_proj_ln_bwd_plain(o, wp, bp, g, dz), tol=1e-3)
    again = wa.qkv_epi_proj_ln_bwd(o, wp, bp, g, dz)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("windows", [5, 21])
def test_attention_backward_tails(dev, windows):
    """K4 (C 96, masked, with LayerNorm) and K5 (C 768, masked, cosine) where the window
    count is not a multiple of the runs their blocks walk: within 1e-2 of the plain
    versions, and second launches bit-equal."""
    gen = torch.Generator().manual_seed(100 + windows)
    T = 64 * windows
    args = _epi_args(gen, dev, 96, T, True, True)
    dz = _randn(gen, dev, T, 96).to(torch.bfloat16)
    kw = dict(ws=64, num_heads=3, sm_scale=32 ** -0.5, has_mask=True)
    got = wa.window_attention_qkv_epi_bwd(*args, dz, **kw)
    _assert_grads_close(got, wa.window_attention_qkv_epi_bwd_plain(*args, dz, **kw))
    again = wa.window_attention_qkv_epi_bwd(*args, dz, **kw)
    assert all(g is None or torch.equal(g, a) for g, a in zip(got, again))
    qkv, groups, bias, ls = _attn_args(gen, dev, 768, T, True)
    dout = _randn(gen, dev, T, 768).to(torch.bfloat16)
    kw = dict(ws=64, num_heads=24, use_cos=True, sm_scale=32 ** -0.5, has_mask=True)
    got = wa.window_attention_bwd(qkv, groups, bias, ls, dout, **kw)
    _assert_grads_close(got, wa.window_attention_bwd_plain(qkv, groups, bias, ls, dout, **kw))
    again = wa.window_attention_bwd(qkv, groups, bias, ls, dout, **kw)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_qkv_kernels_probabilities_near_underflow(dev):
    """K16's and K17's bf16 probabilities, read through the probes above (one window,
    C 64, x one-hot on every row so that q, k and v are exact rows of Wqkv) on rows whose
    biases fall from 0 to -100 across the keys: each within one bf16 ulp of bf16(e / d)
    computed in f32, down to bf16's subnormals and at the e <= 2^-134 whose division the
    kernels skip; K16's and K17's equal bit for bit where both give them."""
    gen = torch.Generator().manual_seed(14)
    C, T = 64, 64
    bf = torch.bfloat16
    x = torch.eye(64, device=dev).to(bf)
    wq = _randn(gen, dev, C, 3 * C, std=1.0)
    wq[:, 2 * C:2 * C + 32] = 0
    wq[:32, 2 * C:2 * C + 32] = torch.eye(32, device=dev)
    wq = wq.to(bf)
    ramp = torch.arange(64, device=dev)
    bias = (-100.0 / 63 * ((ramp[None, :] + ramp[:, None]) % 64)).reshape(1, 64, 64)
    bias = bias.expand(2, 64, 64).contiguous()
    kw = dict(ws=64, num_heads=2, use_cos=False, sm_scale=32 ** -0.5, has_mask=False)
    args = (x, wq, None, None, bias, None)
    o = wa.window_attention_qkv_fwd(*args, **kw)
    _, dwq, *_ = wa.window_attention_qkv_bwd(*args, _probe_dout(dev, T, C), **kw)
    torch.cuda.synchronize()
    qkv = wa._qkv_rows(x, wq, None).reshape(1, 64, 3, 2, 32)
    p = wa._softmax(wa._scores(qkv[:, :, 0], qkv[:, :, 1], None, bias, False, 32 ** -0.5))
    want = p[0, 0].to(bf).double()  # (query, key)
    assert ((want > 0) & (want < 2.0 ** -126)).any() and (p[0, 0] <= 2.0 ** -134).any()
    got16 = o[:, :32].double()  # (query, key < 32)
    got17 = dwq[:, 2 * C:2 * C + 32].t().double()  # (query < 32, key)
    for got, w in ((got16, want[:, :32]), (got17, want[:32])):
        assert ((got - w).abs() <= 2.0 ** -7 * w.abs() + 2.0 ** -133).all()
    assert torch.equal(got16[:32], got17[:, :32])


@pytest.mark.parametrize("T,C", [(262144, 96), (65536, 192), (16384, 384), (1024, 32),
                                 (1024, 160)])
def test_gemm_nt(dev, T, C):
    """K17's dx product dqkv Wqkv^T (``gemm_nt``) against its plain twin at the three
    stage shapes and at widths that leave a partial 96-column tile (32, 160): the same
    f32 sums in another order, rounded to bf16, so relative L2 under 1e-3."""
    gen = torch.Generator().manual_seed(50 + C)
    a = _randn(gen, dev, T, 3 * C).to(torch.bfloat16)
    b = _randn(gen, dev, C, 3 * C, std=C ** -0.5).to(torch.bfloat16)
    got = wa.gemm_nt(a, b)
    torch.cuda.synchronize()
    assert got.shape == (T, C) and got.dtype == torch.bfloat16
    assert _rel_l2(got, wa.gemm_nt_plain(a, b)) < 1e-3


def test_qkv_function_backward_through_kernels(dev):
    """``window_attention_qkv``: forward K16, backward K17, each launched once; the
    gradients in each operand's dtype, within 1e-2 of the plain path's."""
    gen = torch.Generator().manual_seed(21)
    C, T = 96, 64 * 8
    x, wq, bq, groups, bias, _ = _qkv_args(gen, dev, C, T, True, False, True)
    kw = dict(ws=64, num_heads=C // 32, use_cos=False, sm_scale=32 ** -0.5, has_mask=True)
    grads = {}
    for impl in ("auto", "xla"):
        leaves = [t.clone().requires_grad_() for t in (x, wq, bq, bias)]
        before = dict(wa.launches)
        out = wa.window_attention_qkv(leaves[0], leaves[1], leaves[2], groups, leaves[3], None,
                                      **kw, impl=impl)
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        n = int(impl == "auto")
        for k in ("window_attention_qkv", "window_attention_qkv_bwd"):
            assert wa.launches[k] == before[k] + n, (impl, k)
        for t in leaves:
            assert t.grad is not None and t.grad.dtype == t.dtype
        grads[impl] = [t.grad for t in leaves]
    _assert_grads_close(grads["auto"], grads["xla"])


DEPTH_CASES = [("l2", 1, 1.0), ("l1", 1, 1.0), ("huber", 1, 0.5), ("nll", 2, 1.0),
               ("l2", 2, 1.0)]


def _depth_args(gen, dev, T, C, F, p=4):
    """Tail operands and (T, p) f32 targets, 35% of them inf (background)."""
    t = torch.randn(T, p, generator=gen)
    t = torch.where(torch.rand(T, p, generator=gen) < 0.35, float("inf"), t)
    return (_randn(gen, dev, T, C).to(torch.bfloat16), _randn(gen, dev, C, p * C, std=0.1),
            1 + _randn(gen, dev, C, std=0.1), _randn(gen, dev, C, std=0.1),
            _randn(gen, dev, C, F, std=0.3), t.to(dev))


@pytest.mark.parametrize("C", [96, 32])
@pytest.mark.parametrize("kind,F,delta", DEPTH_CASES)
def test_final_head_depth_loss_kernels(dev, kind, F, delta, C):
    """K8 (loss sum, count, bf16 predictions) and K9 (every gradient) against their
    plain versions; each launch counted, a second launch gives the same bits."""
    gen = torch.Generator().manual_seed(8)
    T, p = 64 * 64, 4
    args = _depth_args(gen, dev, T, C, F)
    kw = dict(patch_size=p, loss_kind=kind, huber_delta=delta)
    keys = [(k, T, C, F, kind) for k in ("final_head_depth_loss", "final_head_depth_loss_bwd")]
    before = [fh.launches[k[0]] for k in keys] + [fh.launches_by_shape[k] for k in keys]
    num, den, preds = fh.final_head_depth_loss_sums(*args, **kw)
    torch.cuda.synchronize()
    wnum, wden, wpreds = fh.final_head_depth_loss_plain(*args, **kw)
    assert float(den) == float(wden) == float(torch.isfinite(args[5]).sum())
    assert abs(float(num) - float(wnum)) <= 1e-3 * abs(float(wnum))
    assert preds.dtype == torch.bfloat16 and tuple(preds.shape) == (T, p * F)
    assert _rel_l2(preds, wpreds) < 1e-2
    scale = torch.tensor(1.3, device=dev) / wden
    got = fh.final_head_depth_loss_bwd(*args, scale, **kw)
    torch.cuda.synchronize()
    after = [fh.launches[k[0]] for k in keys] + [fh.launches_by_shape[k] for k in keys]
    assert after == [n + 1 for n in before]
    _assert_grads_close(got, fh.final_head_depth_loss_bwd_plain(*args, scale, **kw))
    if F == 2 and kind != "nll":  # the logvar channel gets no gradient
        assert float(got[4][:, 1].abs().max()) == 0.0
    again = fh.final_head_depth_loss_bwd(*args, scale, **kw)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert all(torch.equal(a, b)
               for a, b in zip((num, den, preds), fh.final_head_depth_loss_sums(*args, **kw)))


def test_final_head_depth_loss_kernels_without_depth(dev):
    """An all-background tile gets exactly 0 gradients; NaN targets are background
    (bit-equal to inf); an all-background batch: count 0, loss sum 0, 0 gradients."""
    gen = torch.Generator().manual_seed(9)
    T, C, p = 64 * 16, 96, 4
    args = list(_depth_args(gen, dev, T, C, 2))
    kw = dict(patch_size=p, loss_kind="nll")
    t = args[5].clone()
    t[:64] = float("inf")
    t[64::5, 2] = float("nan")
    t_inf = torch.where(torch.isnan(t), float("inf"), t)
    one = torch.ones((), device=dev)
    res = [fh.final_head_depth_loss_sums(*args[:5], tt, **kw) for tt in (t, t_inf)]
    grads = [fh.final_head_depth_loss_bwd(*args[:5], tt, one / res[0][1], **kw)
             for tt in (t, t_inf)]
    torch.cuda.synchronize()
    assert float(res[0][1]) == float(torch.isfinite(t).sum())
    assert all(torch.equal(a, b) for a, b in zip(*res))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert torch.isfinite(grads[0][0].float()).all()
    assert float(grads[0][0][:64].float().abs().max()) == 0.0
    _assert_grads_close(grads[0], fh.final_head_depth_loss_bwd_plain(*args[:5], t,
                                                                     one / res[0][1], **kw))
    bg = torch.full_like(t, float("inf"))
    num, den, _ = fh.final_head_depth_loss_sums(*args[:5], bg, **kw)
    assert float(num) == 0.0 and float(den) == 0.0
    for g in fh.final_head_depth_loss_bwd(*args[:5], bg, one, **kw):
        assert float(g.float().abs().max()) == 0.0


def test_final_head_depth_loss_function_backward_through_kernels(dev):
    """The autograd function: K8 forward, K9 backward, each launched once; the
    predictions carry no gradient; each gradient in its operand's dtype."""
    gen = torch.Generator().manual_seed(10)
    args = list(_depth_args(gen, dev, 64 * 16, 96, 1))
    for i in range(5):
        args[i] = args[i].clone().requires_grad_()
    before = dict(fh.launches)
    loss, preds = fh.final_head_depth_loss(*args, patch_size=4, loss_kind="l2")
    loss.backward()
    torch.cuda.synchronize()
    assert fh.launches["final_head_depth_loss"] == before["final_head_depth_loss"] + 1
    assert fh.launches["final_head_depth_loss_bwd"] == before["final_head_depth_loss_bwd"] + 1
    assert not preds.requires_grad and tuple(preds.shape) == (64 * 16, 4)
    for t in args[:5]:
        assert t.grad is not None and t.grad.dtype == t.dtype
        assert torch.isfinite(t.grad.float()).all()


def test_depth_kernels_refuse_what_they_do_not_take(dev):
    """Under "pallas" the depth wrappers raise on what K8/K9 do not take."""
    gen = torch.Generator().manual_seed(11)
    args = _depth_args(gen, dev, 128, 32, 1)
    one = torch.ones((), device=dev)
    for kw, match in ((dict(loss_kind="ce", impl="pallas"), "unknown loss kind"),
                      (dict(loss_kind="nll", impl="pallas"), "needs F=2")):
        with pytest.raises(ValueError, match=match):
            fh.final_head_depth_loss_sums(*args, patch_size=4, **kw)
        with pytest.raises(ValueError, match=match):
            fh.final_head_depth_loss_bwd(*args, one, patch_size=4, **kw)
    three = _depth_args(gen, dev, 128, 32, 3)
    with pytest.raises(ValueError, match="F in"):
        fh.final_head_depth_loss_sums(*three, patch_size=4, loss_kind="l2", impl="pallas")
    ragged = _depth_args(gen, dev, 96, 32, 1)
    with pytest.raises(ValueError, match="multiple of 64"):
        fh.final_head_depth_loss_sums(*ragged, patch_size=4, loss_kind="l2", impl="pallas")
    narrow = _depth_args(gen, dev, 128, 40, 1)
    with pytest.raises(ValueError, match="C % 16"):
        fh.final_head_depth_loss_sums(*narrow, patch_size=4, loss_kind="l2", impl="pallas")
    wide = _depth_args(gen, dev, 128, 144, 1)
    with pytest.raises(ValueError, match="C <= 128"):
        fh.final_head_depth_loss_bwd(*wide, one, patch_size=4, loss_kind="l2", impl="pallas")
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fh.final_head_depth_loss_sums(args[0].half(), *args[1:], patch_size=4,
                                      loss_kind="l2", impl="pallas")


@pytest.mark.parametrize("C", [32, 64, 96, 128])
@pytest.mark.parametrize("kind,F,delta", [("l2", 1, 1.0), ("nll", 2, 1.0)])
def test_final_head_depth_loss_kernels_at_every_width(dev, C, kind, F, delta):
    """K8 and K9 at each instantiation of the tail row core (C 32 to 128, p 4) on a T
    whose last 128-row tile is half full, against their plain versions; two K9 launches
    bit-equal."""
    gen = torch.Generator().manual_seed(40 + C + F)
    T, p = 64 * 65, 4
    args = _depth_args(gen, dev, T, C, F, p)
    kw = dict(patch_size=p, loss_kind=kind, huber_delta=delta)
    num, den, preds = fh.final_head_depth_loss_sums(*args, **kw)
    torch.cuda.synchronize()
    wnum, wden, wpreds = fh.final_head_depth_loss_plain(*args, **kw)
    assert float(den) == float(wden)
    assert abs(float(num) - float(wnum)) <= 1e-3 * abs(float(wnum))
    assert _rel_l2(preds, wpreds) < 1e-2
    scale = torch.tensor(0.7, device=dev) / wden
    got = fh.final_head_depth_loss_bwd(*args, scale, **kw)
    _assert_grads_close(got, fh.final_head_depth_loss_bwd_plain(*args, scale, **kw))
    again = fh.final_head_depth_loss_bwd(*args, scale, **kw)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("T,C,kind,F", [(64 * 65, 96, "l2", 1), (64 * 33, 32, "nll", 2),
                                        (64 * 65, 64, "huber", 1), (262144, 96, "l2", 1)])
def test_final_head_depth_loss_bwd_sequence_kernels(dev, T, C, kind, F):
    """Each step of K9's launch sequence against its plain twin: the row kernel (dx, dh,
    the partial rows on its grid), ``gemm_tn`` (dWe = x^T dh) and ``reduce_rows``, each
    on the kernel's own input; and K9 is the three steps composed, bit for bit."""
    gen = torch.Generator().manual_seed(T + C + F)
    p = 4
    args = _depth_args(gen, dev, T, C, F, p)
    kw = dict(patch_size=p, loss_kind=kind, huber_delta=0.5)
    scale = torch.tensor(1.3, device=dev) / torch.isfinite(args[5]).sum()
    dx, dh, part = fh.final_head_depth_loss_bwd_rows(*args, scale, **kw)
    grid = part.shape[0]
    assert 1 <= grid <= -(-T // fh.TAIL_TILE_ROWS)
    _assert_grads_close((dx, dh, part), fh.final_head_depth_loss_bwd_rows_plain(
        *args, scale, **kw, grid=grid))
    dwe = fh.final_head_loss_dwe(args[0], dh)
    _assert_grads_close((dwe,), (fh.final_head_loss_dwe_plain(args[0], dh),), tol=1e-5)
    red = fh.reduce_rows(part)
    _assert_grads_close((red,), (fh.reduce_rows_plain(part),), tol=1e-5)
    dwh, dg, db = red.split([C * F, C, C])
    whole = fh.final_head_depth_loss_bwd(*args, scale, **kw)
    assert all(torch.equal(a, b) for a, b in zip(whole, (dx, dwe, dg, db, dwh.reshape(C, F))))


@pytest.mark.parametrize("T,C,kind,F", [(64 * 65, 32, "l2", 1), (64 * 65, 96, "nll", 2),
                                        (64 * 33, 128, "l2", 2), (262144, 96, "l2", 1)])
def test_final_head_depth_loss_bwd_recomputes_the_forward_logits(dev, T, C, kind, F):
    """K9's row kernel recomputes K8's f32 logits bit for bit: both kernels' logits
    taps, ``torch.equal``; K8's predictions are its tap rounded to bf16; both near the
    plain version's logits."""
    gen = torch.Generator().manual_seed(T + C + 3)
    p = 4
    args = _depth_args(gen, dev, T, C, F, p)
    kw = dict(patch_size=p, loss_kind=kind)
    _, _, preds, lf8 = fh.final_head_depth_loss_sums(*args, **kw, tap_logits=True)
    lf9 = fh.final_head_depth_loss_bwd_rows(*args, torch.tensor(1.0, device=dev), **kw,
                                            tap_logits=True)[-1]
    assert lf8.shape == (T, p, F) and lf8.dtype == torch.float32
    assert int((lf8 != 0).sum()) > T * p * F // 2
    assert torch.equal(lf8, lf9)
    assert torch.equal(preds, lf8.reshape(T, p * F).to(torch.bfloat16))
    assert _rel_l2(lf8, fh.final_head_logits_plain(*args[:5], patch_size=p)) < 1e-2


def test_depth_kernels_refuse_widths_without_an_instantiation(dev):
    """K8 and K9 hold a row in mma accumulators, one instantiation per C in 32, 64, 96,
    128: the other widths of C % 16 raise under "auto", naming
    impl="xla", with no launch, and run the plain version under "xla"; F 3 raises."""
    gen = torch.Generator().manual_seed(15)
    one = torch.ones((), device=dev)
    kw = dict(patch_size=4, loss_kind="l2")
    for C in (16, 48, 80, 112):
        args = _depth_args(gen, dev, 128, C, 1)
        before = dict(fh.launches)
        with pytest.raises(ValueError, match="C % 32 == 0 and C <= 128.*impl='xla'"):
            fh.final_head_depth_loss_sums(*args, **kw)
        with pytest.raises(ValueError, match="C % 32 == 0 and C <= 128.*impl='xla'"):
            fh.final_head_depth_loss_bwd(*args, one, **kw)
        with pytest.raises(ValueError, match="C % 32 == 0 and C <= 128.*impl='xla'"):
            fh.final_head_depth_loss_bwd_rows(*args, one, **kw)
        got = fh.final_head_depth_loss_sums(*args, **kw, impl="xla")
        assert dict(fh.launches) == before
        assert all(torch.equal(a, b) for a, b in zip(got, fh.final_head_depth_loss_plain(
            *args, **kw)))
    three = _depth_args(gen, dev, 128, 32, 3)
    with pytest.raises(ValueError, match="F in.*impl='xla'"):
        fh.final_head_depth_loss_sums(*three, **kw)
    with pytest.raises(ValueError, match="F in.*impl='xla'"):
        fh.final_head_depth_loss_bwd(*three, one, **kw)


def _cloud(gen, dev, n, scale=5.0):
    return (torch.randn(n, 3, generator=gen) * scale).to(dev)


@pytest.mark.parametrize("n,m,nv,mv", [(5000, 7000, 5000, 7000), (3000, 2500, 2999, 1),
                                       (700, 300, 700, 300), (4096, 2048, 1000, 2048)])
def test_chamfer_min_both_kernel(dev, n, m, nv, mv):
    """K10 against its plain version, bit-equal: whole clouds, a side under one tile,
    a single valid point, and padding rows masked by count (placed where they would
    win if they counted)."""
    from heal_swin_torch.ops import chamfer as ch

    gen = torch.Generator().manual_seed(12)
    p, q = _cloud(gen, dev, n), _cloud(gen, dev, m)
    p[nv:] = q[0]
    q[mv:] = p[0]
    key = ("chamfer_min_both", n, m)
    before = ch.launches_by_shape[key]
    got = ch.chamfer_min_both(p, q, nv, mv)
    torch.cuda.synchronize()
    assert ch.launches_by_shape[key] == before + 1
    want = ch.chamfer_min_both_plain(p, q, nv, mv)
    for g, w in zip(got, want):
        assert torch.equal(g, w), int((g != w).sum())
    assert torch.isinf(got[0][nv:]).all() and torch.isinf(got[1][mv:]).all()
    again = ch.chamfer_min_both(p, q, nv, mv)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("n,m", [(5000, 7000), (700, 3000), (3000, 300)])
def test_chamfer_fold_pairs_kernel(dev, n, m):
    """K11 against its plain version, bit-equal, on every tile pair (an all-padding
    tile among them) merged into minima that already hold values; and the pruned
    route end to end against the brute one."""
    from heal_swin_torch.ops import chamfer as ch
    from heal_swin_torch.ops import chamfer_pruned as chp

    T = chp._TP
    gen = torch.Generator().manual_seed(13)
    npt, nqt = -(-n // T) + 1, -(-m // T)  # one p tile beyond the valid points
    ptab = torch.randn(npt, 3, T, generator=gen).to(dev) * 5
    qtab = torch.randn(nqt, 3, T, generator=gen).to(dev) * 5
    pairs = torch.tensor([[i, j] for i in range(npt) for j in range(nqt)],
                         dtype=torch.int32, device=dev)
    seed_p = torch.rand(npt * T, generator=gen).to(dev) * 0.01
    seed_q = torch.full((nqt * T,), float("inf"), device=dev)
    key = ("chamfer_fold_pairs", pairs.shape[0])
    before = chp.launches_by_shape[key]
    got = chp.chamfer_fold_pairs(pairs, ptab, qtab, n, m, seed_p.clone(), seed_q.clone())
    torch.cuda.synchronize()
    assert chp.launches_by_shape[key] == before + 1
    want = chp.chamfer_fold_pairs_plain(pairs, ptab, qtab, n, m, seed_p.clone(), seed_q.clone())
    for g, w in zip(got, want):
        assert torch.equal(g, w), int((g != w).sum())
    assert torch.equal(got[0][n:], seed_p[n:]) and torch.isinf(got[1][m:]).all()

    rng = torch.Generator().manual_seed(14)
    p = (torch.randn(n, 3, generator=rng) * 5).numpy()
    q = (torch.randn(m, 3, generator=rng) * 5).numpy()
    pruned, brute = {}, {}
    vp = ch.chamfer_distance(p, q, route="pruned", device=dev, stats=pruned)
    vb = ch.chamfer_distance(p, q, route="brute", device=dev, stats=brute)
    assert vp == vb
    for k in ("d_pq", "d_qp"):
        assert pruned[k].tobytes() == brute[k].tobytes()
    chp.clear()


def test_chamfer_kernels_refuse_what_they_do_not_take(dev):
    from heal_swin_torch.ops import chamfer as ch
    from heal_swin_torch.ops import chamfer_pruned as chp

    p = torch.zeros(10, 3, device=dev)
    with pytest.raises(ValueError, match="float32"):
        ch.chamfer_min_both(p.double(), p)
    with pytest.raises(ValueError, match="out of range"):
        ch.chamfer_min_both(p, p, 11, 10)
    tab = torch.zeros(1, 3, 1024, device=dev)
    mins = torch.zeros(1024, device=dev)
    with pytest.raises(ValueError, match="int32"):
        chp.chamfer_fold_pairs(torch.zeros(1, 2, dtype=torch.int64, device=dev), tab, tab,
                               10, 10, mins, mins.clone())
    with pytest.raises(ValueError, match="table"):
        chp.chamfer_fold_pairs(torch.zeros(1, 2, dtype=torch.int32, device=dev), tab[:, :2],
                               tab, 10, 10, mins, mins.clone())


def _mlp_args(gen, dev, T, C, H):
    """K12-K15 operands: x (T, C) bf16, w1 (C, H), b1, w2 (H, C), b2, gamma, beta."""
    return (_randn(gen, dev, T, C).to(torch.bfloat16), _randn(gen, dev, C, H, std=C ** -0.5),
            _randn(gen, dev, H, std=0.1), _randn(gen, dev, H, C, std=H ** -0.5),
            _randn(gen, dev, C, std=0.1), 1 + _randn(gen, dev, C, std=0.1),
            _randn(gen, dev, C, std=0.1))


@pytest.mark.parametrize("T,C", [(64 * 4, 32), (64 * 8, 96), (64 * 4, 384), (64 * 2, 768),
                                 (262144, 96)])
@pytest.mark.parametrize("approximate", [True, False])
def test_mlp_kernels(dev, T, C, approximate):
    """K12 and K13 against their plain versions (relative L2 1e-2 for the output and
    every gradient), each launch counted; a second K13 launch gives the same bits."""
    from heal_swin_torch.ops import mlp as tm

    gen = torch.Generator().manual_seed(C + approximate)
    H = 4 * C
    args = _mlp_args(gen, dev, T, C, H)[:5]
    dout = _randn(gen, dev, T, C).to(torch.bfloat16)
    key = (T, C, H, approximate)
    before = [tm.launches_by_shape[(k,) + key] for k in ("mlp_fwd", "mlp_bwd")]
    out = tm.mlp_fwd(*args, approximate=approximate)
    grads = tm.mlp_bwd(*args, dout, approximate=approximate)
    again = tm.mlp_bwd(*args, dout, approximate=approximate)
    torch.cuda.synchronize()
    assert [tm.launches_by_shape[(k,) + key] for k in ("mlp_fwd", "mlp_bwd")] == [
        before[0] + 1, before[1] + 2]
    assert out.dtype == torch.bfloat16
    assert _rel_l2(out, tm.mlp_plain(*args, approximate=approximate)) < 1e-2
    _assert_grads_close(grads, tm.mlp_bwd_plain(*args, dout, approximate=approximate))
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("T,C", [(64 * 4, 32), (64 * 8, 96), (64 * 4, 192), (64 * 4, 384),
                                 (64 * 2, 768), (262144, 96)])
@pytest.mark.parametrize("has_dp", [False, True])
def test_mlp_block_kernels(dev, T, C, has_dp):
    """K14 and K15 against their plain versions, with and without the DropPath scale
    (whole dropped rows get exactly the residual back)."""
    from heal_swin_torch.ops import mlp as tm

    gen = torch.Generator().manual_seed(C + 1000 * has_dp)
    H = 4 * C
    args = _mlp_args(gen, dev, T, C, H)
    ds = None
    if has_dp:
        ds = torch.where(torch.rand(T, 1, generator=gen) < 0.3, 0.0, 1.25).to(dev)
    dz = _randn(gen, dev, T, C).to(torch.bfloat16)
    for approximate in (True, False):
        key = (T, C, H, approximate, has_dp)
        before = [tm.launches_by_shape[(k,) + key] for k in ("mlp_block_fwd", "mlp_block_bwd")]
        out = tm.mlp_block_fwd(*args, ds, approximate=approximate)
        grads = tm.mlp_block_bwd(*args, ds, dz, approximate=approximate)
        torch.cuda.synchronize()
        assert [tm.launches_by_shape[(k,) + key] for k in ("mlp_block_fwd", "mlp_block_bwd")] \
            == [b + 1 for b in before]
        assert _rel_l2(out, tm.mlp_block_plain(*args, ds, approximate=approximate)) < 1e-2
        _assert_grads_close(grads, tm.mlp_block_bwd_plain(*args, ds, dz,
                                                          approximate=approximate))
        if has_dp:
            dropped = (ds == 0).reshape(-1)
            assert torch.equal(out[dropped], args[0][dropped])
            assert torch.equal(grads[0][dropped], dz[dropped])


@pytest.mark.parametrize("T", [64 * 8, 262144])
@pytest.mark.parametrize("approximate", [True, False])
def test_mlp_backward_kernels_tell_the_gelus_apart(dev, T, approximate):
    """K13 / K15's f32 db1 (the sum of the unrounded dh) matches the plain version of
    its own GELU within a limit and lies further than that from the other GELU's,
    which the bf16 outputs cannot tell apart.  K15's limit is wider: its dh comes
    from the bf16-rounded du, whose roundings the summation order can flip."""
    from heal_swin_torch.ops import mlp as tm

    gen = torch.Generator().manual_seed(31 + approximate)
    C, H = 96, 384
    args = _mlp_args(gen, dev, T, C, H)
    dz = _randn(gen, dev, T, C).to(torch.bfloat16)
    ds = torch.where(torch.rand(T, 1, generator=gen) < 0.3, 0.0, 1.25).to(dev)
    for kernel, plain, a, tol in (
            (tm.mlp_bwd, tm.mlp_bwd_plain, args[:5] + (dz,), 2e-6),
            (tm.mlp_block_bwd, tm.mlp_block_bwd_plain, args + (ds, dz), 2e-4)):
        db1 = kernel(*a, approximate=approximate)[2]
        err = _rel_l2(db1, plain(*a, approximate=approximate)[2])
        dist = _rel_l2(db1, plain(*a, approximate=not approximate)[2])
        assert err <= tol < dist, (kernel.__name__, err, dist)


def test_mlp_functions_backward_through_kernels(dev):
    """``fused_mlp`` (both forwards), ``fused_mlp_nd`` and ``fused_mlp_block`` launch
    their kernels forward and backward and return gradients in their operands'
    dtypes."""
    from heal_swin_torch.ops import mlp as tm

    gen = torch.Generator().manual_seed(21)
    x, w1, b1, w2, b2, g, b = (a.clone().requires_grad_()
                               for a in _mlp_args(gen, dev, 64 * 4, 96, 384))
    before = dict(tm.launches)
    tm.fused_mlp(x, w1, b1, w2, b2, approximate=True, fwd_impl="pallas").float().sum().backward()
    tm.fused_mlp(x, w1, b1, w2, b2, approximate=True).float().sum().backward()
    tm.fused_mlp_nd(x.reshape(4, 64, 96), w1, b1, w2, b2,
                    approximate=False).float().sum().backward()
    tm.fused_mlp_block(x, w1, b1, w2, b2, g, b, approximate=True).float().sum().backward()
    torch.cuda.synchronize()
    assert {k: tm.launches[k] - before[k] for k in before} == dict(
        mlp_fwd=1, mlp_bwd=3, mlp_block_fwd=1, mlp_block_bwd=1)
    for t in (x, w1, b1, w2, b2, g, b):
        assert t.grad is not None and t.grad.dtype == t.dtype and torch.isfinite(t.grad).all()


@pytest.mark.parametrize("C", [96, 384])
@pytest.mark.parametrize("approximate", [True, False])
def test_mlp_bwd_recomputes_the_forward_hidden(dev, C, approximate):
    """K13 recomputes K12's g bit for bit: with W2 = [I; 0] and b2 = 0 K12's out is
    g[:, :C], and for dout one-hot at (t, c) K13's dW2[:C, c] is g[t, :C] (one row group
    over two warps at C 384).  The two must be equal."""
    from heal_swin_torch.ops import mlp as tm

    gen = torch.Generator().manual_seed(110 + C + approximate)
    T, H = 64 * 3, 4 * C
    x, w1, b1, _, _ = _mlp_args(gen, dev, T, C, H)[:5]
    w2 = torch.zeros(H, C, device=dev)
    w2[:C] = torch.eye(C, device=dev)
    b2 = torch.zeros(C, device=dev)
    out = tm.mlp_fwd(x, w1, b1, w2, b2, approximate=approximate)
    for t, c in ((0, 0), (T - 1, C - 1), (100, C // 2)):
        dout = torch.zeros(T, C, device=dev, dtype=torch.bfloat16)
        dout[t, c] = 1
        dw2 = tm.mlp_bwd(x, w1, b1, w2, b2, dout, approximate=approximate)[3]
        torch.cuda.synchronize()
        assert (out[t] != 0).sum() > C // 2  # the probe reads real activations
        assert torch.equal(dw2[:C, c], out[t].float())


@pytest.mark.parametrize("T,C", [(262144, 96), (65536, 192), (16384, 384), (4096, 768)])
def test_mlp_bwd_sequence_kernels(dev, T, C):
    """K13's two kernels alone against their plain versions at the four stage shapes
    (tanh GELU): the dx kernel's dx and the weight-gradient kernel's dW1, db1, dW2, db2
    within relative L2 1e-3 (the same roundings, f32 sums in another order)."""
    from heal_swin_torch.ops import mlp as tm

    gen = torch.Generator().manual_seed(120 + C)
    H = 4 * C
    x, w1, b1, w2, _ = _mlp_args(gen, dev, T, C, H)[:5]
    dout = _randn(gen, dev, T, C).to(torch.bfloat16)
    kw = dict(approximate=True)
    dx = tm.mlp_bwd_dx(x, w1, b1, w2, dout, **kw)
    dw = tm.mlp_bwd_dw(x, w1, b1, w2, dout, **kw)
    torch.cuda.synchronize()
    _assert_grads_close((dx,), (tm.mlp_bwd_dx_plain(x, w1, b1, w2, dout, **kw),), tol=1e-3)
    _assert_grads_close(dw, tm.mlp_bwd_dw_plain(x, w1, b1, w2, dout, **kw), tol=1e-3)


@pytest.mark.parametrize("T,C,H", [(64 * 3, 32, 96), (64 * 5, 96, 160), (64 * 3, 384, 224),
                                   (64 * 2, 768, 96), (64 * 4, 224, 96)])
@pytest.mark.parametrize("approximate", [True, False])
def test_mlp_kernels_hidden_tail(dev, T, C, H, approximate):
    """K12 and K13 where H is a multiple of 32 but not of the weight-gradient kernel's
    64-column slice (or not 4C), and T leaves a partial row block: within 1e-3 of their
    plain versions, a second K13 launch bit-equal."""
    from heal_swin_torch.ops import mlp as tm

    gen = torch.Generator().manual_seed(130 + C + H)
    args = _mlp_args(gen, dev, T, C, H)[:5]
    dout = _randn(gen, dev, T, C).to(torch.bfloat16)
    kw = dict(approximate=approximate)
    out = tm.mlp_fwd(*args, **kw)
    grads = tm.mlp_bwd(*args, dout, **kw)
    again = tm.mlp_bwd(*args, dout, **kw)
    torch.cuda.synchronize()
    assert _rel_l2(out, tm.mlp_plain(*args, **kw)) < 1e-3
    _assert_grads_close(grads, tm.mlp_bwd_plain(*args, dout, **kw), tol=1e-3)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


MLP_BLOCK_BWD_TOL = 4e-3  # chip_smoke.py's MLP_REL_L2_TOL for K15 (dx as dx - dz)


@pytest.mark.parametrize("C", [96, 384])
@pytest.mark.parametrize("approximate", [True, False])
def test_mlp_block_bwd_recomputes_the_forward_xhat(dev, C, approximate):
    """K15 recomputes K14's xhat bit for bit: with gamma = 1, beta = 0, no dscale and dz
    one on every column of row t and zero elsewhere, K15's dgamma is xhat[t, :], and
    bf16(x[t] + dgamma) must equal K14's out[t] (one row group over two warps at C
    384)."""
    from heal_swin_torch.ops import mlp as tm

    gen = torch.Generator().manual_seed(140 + C + approximate)
    T, H = 64 * 3, 4 * C
    x, w1, b1, w2, b2, _, _ = _mlp_args(gen, dev, T, C, H)
    gamma, beta = torch.ones(C, device=dev), torch.zeros(C, device=dev)
    kw = dict(approximate=approximate)
    out = tm.mlp_block_fwd(x, w1, b1, w2, b2, gamma, beta, None, **kw)
    for t in (0, T - 1, 100):
        dz = torch.zeros(T, C, device=dev, dtype=torch.bfloat16)
        dz[t] = 1
        dgamma = tm.mlp_block_bwd(x, w1, b1, w2, b2, gamma, beta, None, dz, **kw)[5]
        torch.cuda.synchronize()
        assert (dgamma != 0).sum() > C // 2  # the probe reads a real row
        assert torch.equal((x[t].float() + dgamma).to(torch.bfloat16), out[t])


@pytest.mark.parametrize("T,C", [(262144, 96), (65536, 192), (16384, 384), (4096, 768)])
def test_mlp_block_bwd_sequence_kernels(dev, T, C):
    """K15's kernels alone and together against their plain versions at the four stage
    shapes (tanh GELU, with the DropPath scale): the first step's du_lo, db2, dgamma and
    dbeta, the dx kernel with the residual on the plain du_lo (dx - dz), and the whole
    K15 (dx - dz and every parameter gradient), within MLP_BLOCK_BWD_TOL; a second K15
    launch gives the same bits."""
    from heal_swin_torch.ops import mlp as tm

    gen = torch.Generator().manual_seed(150 + C)
    H = 4 * C
    x, w1, b1, w2, b2, gamma, beta = args = _mlp_args(gen, dev, T, C, H)
    ds = torch.where(torch.rand(T, 1, generator=gen) < 0.3, 0.0, 1.25).to(dev)
    dz = _randn(gen, dev, T, C).to(torch.bfloat16)
    dzf = dz.float()
    kw = dict(approximate=True)
    du = tm.mlp_block_bwd_du(x, w1, b1, w2, b2, gamma, ds, dz, **kw)
    du_p = tm.mlp_block_du_plain(x, w1, b1, w2, b2, gamma, ds, dz, **kw)
    dx = tm.mlp_bwd_dx(x, w1, b1, w2, du_p[0], residual=dz, **kw)
    dx_p = tm.mlp_bwd_dx_plain(x, w1, b1, w2, du_p[0], residual=dz, **kw)
    grads = tm.mlp_block_bwd(*args, ds, dz, **kw)
    again = tm.mlp_block_bwd(*args, ds, dz, **kw)
    torch.cuda.synchronize()
    _assert_grads_close(du, du_p, tol=MLP_BLOCK_BWD_TOL)
    _assert_grads_close((dx.float() - dzf,), (dx_p.float() - dzf,), tol=MLP_BLOCK_BWD_TOL)
    want = tm.mlp_block_bwd_plain(*args, ds, dz, **kw)
    _assert_grads_close((grads[0].float() - dzf,) + grads[1:],
                        (want[0].float() - dzf,) + want[1:], tol=MLP_BLOCK_BWD_TOL)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("T,C,H", [(64 * 3, 32, 96), (64 * 5, 96, 160), (64 * 3, 384, 224),
                                   (64 * 2, 768, 96), (64 * 4, 224, 96)])
@pytest.mark.parametrize("approximate", [True, False])
def test_mlp_block_kernels_hidden_tail(dev, T, C, H, approximate):
    """K14 and K15 where H is a multiple of 32 but not of the weight-gradient kernel's
    64-column slice (or not 4C), and T leaves a partial row block, with the DropPath
    scale: the branch z - x and K15's dx - dz and parameter gradients within 1e-3 /
    MLP_BLOCK_BWD_TOL of their plain versions, a second K15 launch bit-equal."""
    from heal_swin_torch.ops import mlp as tm

    gen = torch.Generator().manual_seed(160 + C + H)
    args = _mlp_args(gen, dev, T, C, H)
    x = args[0].float()
    ds = torch.where(torch.rand(T, 1, generator=gen) < 0.3, 0.0, 1.25).to(dev)
    dz = _randn(gen, dev, T, C).to(torch.bfloat16)
    dzf = dz.float()
    kw = dict(approximate=approximate)
    out = tm.mlp_block_fwd(*args, ds, **kw)
    grads = tm.mlp_block_bwd(*args, ds, dz, **kw)
    again = tm.mlp_block_bwd(*args, ds, dz, **kw)
    torch.cuda.synchronize()
    assert _rel_l2(out.float() - x, tm.mlp_block_plain(*args, ds, **kw).float() - x) < 1e-3
    want = tm.mlp_block_bwd_plain(*args, ds, dz, **kw)
    _assert_grads_close((grads[0].float() - dzf,) + grads[1:],
                        (want[0].float() - dzf,) + want[1:], tol=MLP_BLOCK_BWD_TOL)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_mlp_kernels_refuse_what_they_do_not_take(dev):
    from heal_swin_torch.ops import mlp as tm

    gen = torch.Generator().manual_seed(22)
    args = _mlp_args(gen, dev, 128, 96, 384)
    cpu = [a.cpu() for a in args]
    with pytest.raises(ValueError, match="pallas"):
        tm.mlp_fwd(*cpu[:5], approximate=True, impl="pallas")
    with pytest.raises(ValueError, match="does not take"):
        tm.mlp_fwd(args[0][:100], *args[1:5], approximate=True)  # T not a multiple of 64
    odd = _mlp_args(gen, dev, 128, 48, 192)
    with pytest.raises(ValueError, match="does not take"):
        tm.mlp_block_fwd(*odd, None, approximate=True)  # C not a multiple of 32
    with pytest.raises(ValueError, match="bfloat16"):
        tm.mlp_bwd(args[0].float(), *args[1:5], args[0], approximate=True)
    with pytest.raises(ValueError, match="dscale"):
        tm.mlp_block_fwd(*args, torch.ones(128, 1, dtype=torch.bfloat16, device=dev),
                         approximate=True)


# --- the f32 K6 / K7 (csrc/final_head_f32.cu): nothing rounded below f32, held to the
# plain versions run in f32 with TF32 off: sums within 1e-5 relative, every gradient and
# each step of K7 within relative L2 1e-5, the confusion matrix equal outside near-ties
F32_TOL = 1e-5


@pytest.fixture
def no_tf32():
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = was


def _loss_args_f32(gen, dev, T, C, F, p=4):
    return (_randn(gen, dev, T, C),) + _loss_args(gen, dev, T, C, F, p)[1:]


def _f32_near_ties(args, p=4):
    """Sub-rows whose top-2 f32 logits lie within 1e-5 of the larger one's magnitude
    (at least 1e-5): the plain and kernel sums in another order may swap them."""
    lf = fh.final_head_logits_plain(*args[:5], patch_size=p)
    top2 = lf.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) <= 1e-5 * top2[..., 0].abs().clamp_min(1.0)


def _check_f32_loss(args, p, scale):
    num, den, cm = fh.final_head_loss_sums(*args, patch_size=p)
    wnum, wden, wcm = fh.final_head_loss_plain(*args, patch_size=p)
    assert abs(float(num) - float(wnum)) <= F32_TOL * abs(float(wnum))
    assert abs(float(den) - float(wden)) <= F32_TOL * abs(float(wden))
    T = args[0].shape[0]
    assert float(cm.sum()) == T * p
    assert float((cm - wcm).abs().sum()) <= 2 * int(_f32_near_ties(args, p).sum())
    got = fh.final_head_loss_bwd(*args, scale, patch_size=p)
    assert all(g.dtype == torch.float32 for g in got)
    _assert_grads_close(got, fh.final_head_loss_bwd_plain(*args, scale, patch_size=p),
                        tol=F32_TOL)
    again = fh.final_head_loss_bwd(*args, scale, patch_size=p)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("C,F", [(32, 8), (64, 16), (96, 8), (96, 5), (128, 12), (128, 16)])
def test_final_head_loss_f32_kernels(dev, no_tf32, C, F):
    """The f32 K6 and K7 at each instantiation (C 32-128, heads of 8 and 16 columns) on a
    T whose last 128-row tile is half full, against their plain versions; counted as
    the f32 kernels; a NaN token counts in no cell."""
    gen = torch.Generator().manual_seed(40 + C + F)
    T, p = 64 * 65, 4
    args = _loss_args_f32(gen, dev, T, C, F, p)
    before = dict(fh.launches)
    _check_f32_loss(args, p, torch.tensor(1.3, device=dev) / args[6].sum())
    torch.cuda.synchronize()
    assert fh.launches["final_head_loss_f32"] == before["final_head_loss_f32"] + 1
    assert fh.launches["final_head_loss_bwd_f32"] == before["final_head_loss_bwd_f32"] + 2
    assert fh.launches["final_head_loss"] == before["final_head_loss"]
    nan_args = (args[0].clone(),) + args[1:]
    nan_args[0][5] = float("nan")
    _, _, cm_nan = fh.final_head_loss_sums(*nan_args, patch_size=p)
    assert float(cm_nan.sum()) == T * p - p


def test_final_head_loss_f32_kernels_at_the_paper_tail(dev, no_tf32):
    """The f32 K6 and K7 at the paper config's tail: T 262,144, C 96, p 4, F 8."""
    gen = torch.Generator().manual_seed(41)
    args = _loss_args_f32(gen, dev, 262144, 96, 8)
    _check_f32_loss(args, 4, torch.tensor(1.0, device=dev) / args[6].sum())


@pytest.mark.parametrize("T,C,F", [(64 * 65, 96, 8), (64 * 33, 32, 16), (262144, 96, 8)])
def test_final_head_loss_f32_bwd_sequence_kernels(dev, no_tf32, T, C, F):
    """Each step of the f32 K7's launch sequence against its plain twin, run in f32: the
    tile kernel (dx and the partial rows [dWe | dWh | dgamma | dbeta] on its grid: the
    bf16 kernels' partition of 128-row tiles) and ``reduce_rows``, each on the kernel's
    own input; and K7 is the two steps composed, bit for bit."""
    gen = torch.Generator().manual_seed(T + C + F + 1)
    p = 4
    args = _loss_args_f32(gen, dev, T, C, F, p)
    scale = torch.tensor(1.3, device=dev) / args[6].sum()
    dx, part = fh.final_head_loss_bwd_rows(*args, scale, patch_size=p)
    assert dx.dtype == part.dtype == torch.float32
    grid = part.shape[0]
    assert 1 <= grid <= -(-T // fh.TAIL_TILE_ROWS)
    assert part.shape[1] == p * C * C + C * F + 2 * C
    _assert_grads_close((dx, part), fh.final_head_loss_bwd_rows_f32_plain(
        *args, scale, patch_size=p, grid=grid), tol=F32_TOL)
    red = fh.reduce_rows(part)
    _assert_grads_close((red,), (fh.reduce_rows_plain(part),), tol=F32_TOL)
    whole = fh.final_head_loss_bwd(*args, scale, patch_size=p)
    assert all(torch.equal(a, b)
               for a, b in zip(whole, (dx,) + fh.split_f32_bwd_row(red, C, F, p)))


@pytest.mark.parametrize("C,F", [(32, 8), (96, 8), (128, 16)])
def test_final_head_loss_f32_bwd_tile_step_blocks(dev, no_tf32, C, F):
    """The f32 K7's tile kernel on a grid of one block per tile (T 64 * 9: four full tiles
    and a half one): each block's partial row is its own tile's [x^T dh | z^T dlogits |
    dgamma | dbeta] (the twin on the same grid), two launches bit-equal; the f32 dWe has
    no step of its own: ``final_head_loss_dwe`` takes bf16 only."""
    gen = torch.Generator().manual_seed(70 + C + F)
    T, p = 64 * 9, 4
    args = _loss_args_f32(gen, dev, T, C, F, p)
    scale = torch.tensor(0.7, device=dev) / args[6].sum()
    dx, part = fh.final_head_loss_bwd_rows(*args, scale, patch_size=p)
    assert part.shape[0] == -(-T // fh.TAIL_TILE_ROWS)
    twin = fh.final_head_loss_bwd_rows_f32_plain(*args, scale, patch_size=p,
                                                 grid=part.shape[0])
    for b in range(part.shape[0]):
        assert _rel_l2(part[b], twin[1][b]) <= F32_TOL, b
    again = fh.final_head_loss_bwd_rows(*args, scale, patch_size=p)
    assert torch.equal(dx, again[0]) and torch.equal(part, again[1])
    with pytest.raises(ValueError, match="bf16"):
        fh.final_head_loss_dwe(args[0], torch.zeros(T, p * C, device=dev))


@pytest.mark.parametrize("T,C,F", [(64 * 65, 32, 16), (64 * 65, 96, 8), (262144, 96, 8)])
def test_final_head_loss_f32_bwd_recomputes_the_forward_logits(dev, no_tf32, T, C, F):
    """The f32 K7's row kernel recomputes the f32 K6's logits bit for bit (both logits
    taps, ``torch.equal``); both within 1e-5 of the plain version's."""
    gen = torch.Generator().manual_seed(T + C + 2)
    p = 4
    args = _loss_args_f32(gen, dev, T, C, F, p)
    lf6 = fh.final_head_loss_sums(*args, patch_size=p, tap_logits=True)[3]
    lf7 = fh.final_head_loss_bwd_rows(*args, torch.tensor(1.0, device=dev), patch_size=p,
                                      tap_logits=True)[-1]
    assert lf6.shape == (T, p, F) and lf6.dtype == torch.float32
    assert torch.equal(lf6, lf7)
    assert _rel_l2(lf6, fh.final_head_logits_plain(*args[:5], patch_size=p)) < F32_TOL


def test_final_head_loss_f32_function_backward_through_kernels(dev):
    """``final_head_loss`` on f32 tokens: the f32 K6 forward, the f32 K7 backward, every
    gradient f32."""
    gen = torch.Generator().manual_seed(42)
    args = list(_loss_args_f32(gen, dev, 64 * 16, 96, 8))
    for i in range(5):
        args[i] = args[i].clone().requires_grad_()
    before = dict(fh.launches)
    loss, cm = fh.final_head_loss(*args, patch_size=4)
    loss.backward()
    torch.cuda.synchronize()
    assert fh.launches["final_head_loss_f32"] == before["final_head_loss_f32"] + 1
    assert fh.launches["final_head_loss_bwd_f32"] == before["final_head_loss_bwd_f32"] + 1
    assert loss.dtype == torch.float32 and float(cm.sum()) == 64 * 16 * 4
    for t in args[:5]:
        assert t.grad is not None and t.grad.dtype == torch.float32


def test_f32_tails_without_a_kernel_refuse(dev):
    """Float32 tokens at C 48 on K3 (predict) raise under "auto" and "pallas" with no
    launch, naming the kernel and impl="xla", as does an f32 depth tail at C 48: the f32
    K3 and K8/K9 have no instantiation of that width; the f32 K6/K7 refuse heads wider
    than 16 columns."""
    gen = torch.Generator().manual_seed(43)
    one = torch.ones((), device=dev)
    args = _loss_args_f32(gen, dev, 128, 48, 8)
    d48 = _depth_args_f32(gen, dev, 128, 48, 2)
    wide = _loss_args_f32(gen, dev, 128, 96, 17)
    before = dict(fh.launches)
    for impl in ("auto", "pallas"):
        with pytest.raises(ValueError, match=r"\(K3\).*C % 32 == 0 and C <= 128.*impl='xla'"):
            fh.final_head_predict(*args[:5], patch_size=4, impl=impl)
        with pytest.raises(ValueError, match=r"\(K8\).*C % 32 == 0 and C <= 128.*impl='xla'"):
            fh.final_head_depth_loss_sums(*d48[:4], d48[4][:, :1], d48[5], patch_size=4,
                                          loss_kind="l2", impl=impl)
        with pytest.raises(ValueError, match=r"\(K9\).*C % 32 == 0 and C <= 128.*impl='xla'"):
            fh.final_head_depth_loss_bwd(*d48, one, patch_size=4, loss_kind="nll", impl=impl)
        with pytest.raises(ValueError, match=r"\(K6\).*F <= 16.*impl='xla'"):
            fh.final_head_loss_sums(*wide, patch_size=4, impl=impl)
        with pytest.raises(ValueError, match=r"\(K7\).*F <= 16.*impl='xla'"):
            fh.final_head_loss_bwd(*wide, one, patch_size=4, impl=impl)
    assert dict(fh.launches) == before


# --- the f32 K8 / K9 (csrc/tail_f32.cuh): K6's and K7's f32 row kernels with the
# masked depth loss, held to the plain versions in f32 with TF32 off: the count exact,
# the loss sum within 1e-5 relative, the f32 predictions and every gradient and step
# within relative L2 1e-5 (F32_TOL)
def _depth_args_f32(gen, dev, T, C, F, p=4):
    return (_randn(gen, dev, T, C),) + _depth_args(gen, dev, T, C, F, p)[1:]


def _check_f32_depth(args, kw, scale):
    T, p, F = args[0].shape[0], kw["patch_size"], args[4].shape[1]
    num, den, preds = fh.final_head_depth_loss_sums(*args, **kw)
    wnum, wden, wpreds = fh.final_head_depth_loss_plain(*args, **kw)
    assert float(den) == float(wden) == float(torch.isfinite(args[5]).sum())
    assert abs(float(num) - float(wnum)) <= F32_TOL * abs(float(wnum))
    assert preds.dtype == torch.float32 and tuple(preds.shape) == (T, p * F)
    assert _rel_l2(preds, wpreds) <= F32_TOL
    got = fh.final_head_depth_loss_bwd(*args, scale, **kw)
    assert all(g.dtype == torch.float32 for g in got)
    _assert_grads_close(got, fh.final_head_depth_loss_bwd_plain(*args, scale, **kw),
                        tol=F32_TOL)
    if F == 2 and kw["loss_kind"] != "nll":  # the logvar channel gets no gradient
        assert float(got[4][:, 1].abs().max()) == 0.0
    again = fh.final_head_depth_loss_bwd(*args, scale, **kw)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("C", [32, 64, 96, 128])
@pytest.mark.parametrize("kind,F,delta", DEPTH_CASES)
def test_final_head_depth_loss_f32_kernels(dev, no_tf32, kind, F, delta, C):
    """The f32 K8 and K9 at each instantiation (C 32-128) for every loss kind and head,
    on a T whose last 128-row tile is half full, against their plain versions; counted
    as the f32 kernels, the bf16 counters untouched."""
    gen = torch.Generator().manual_seed(60 + C + F)
    T, p = 64 * 65, 4
    args = _depth_args_f32(gen, dev, T, C, F, p)
    kw = dict(patch_size=p, loss_kind=kind, huber_delta=delta)
    before = dict(fh.launches)
    _check_f32_depth(args, kw, torch.tensor(1.3, device=dev) / torch.isfinite(args[5]).sum())
    torch.cuda.synchronize()
    assert fh.launches["final_head_depth_loss_f32"] == before["final_head_depth_loss_f32"] + 1
    assert (fh.launches["final_head_depth_loss_bwd_f32"]
            == before["final_head_depth_loss_bwd_f32"] + 2)
    assert fh.launches["final_head_depth_loss"] == before["final_head_depth_loss"]
    assert fh.launches["final_head_depth_loss_bwd"] == before["final_head_depth_loss_bwd"]


def test_final_head_depth_loss_f32_kernels_at_the_paper_tail(dev, no_tf32):
    """The f32 K8 and K9 at the depth paper config's tail: T 262,144, C 96, p 4, l2, F 1."""
    gen = torch.Generator().manual_seed(61)
    args = _depth_args_f32(gen, dev, 262144, 96, 1)
    _check_f32_depth(args, dict(patch_size=4, loss_kind="l2"),
                     torch.tensor(1.0, device=dev) / torch.isfinite(args[5]).sum())


def test_final_head_depth_loss_f32_kernels_without_depth(dev, no_tf32):
    """In f32 as in bf16: an all-background tile gets exactly 0 gradients, NaN targets are
    background (bit-equal to inf), an all-background batch gives count 0, loss sum 0 and
    exactly 0 gradients."""
    gen = torch.Generator().manual_seed(62)
    T, p = 64 * 16, 4
    args = list(_depth_args_f32(gen, dev, T, 96, 2))
    kw = dict(patch_size=p, loss_kind="nll")
    t = args[5].clone()
    t[:64] = float("inf")
    t[64::5, 2] = float("nan")
    t_inf = torch.where(torch.isnan(t), float("inf"), t)
    one = torch.ones((), device=dev)
    res = [fh.final_head_depth_loss_sums(*args[:5], tt, **kw) for tt in (t, t_inf)]
    grads = [fh.final_head_depth_loss_bwd(*args[:5], tt, one / res[0][1], **kw)
             for tt in (t, t_inf)]
    assert float(res[0][1]) == float(torch.isfinite(t).sum())
    assert all(torch.equal(a, b) for a, b in zip(*res))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert float(grads[0][0][:64].abs().max()) == 0.0
    bg = torch.full_like(t, float("inf"))
    num, den, _ = fh.final_head_depth_loss_sums(*args[:5], bg, **kw)
    assert float(num) == 0.0 and float(den) == 0.0
    for g in fh.final_head_depth_loss_bwd(*args[:5], bg, one, **kw):
        assert float(g.abs().max()) == 0.0


@pytest.mark.parametrize("T,C,kind,F", [(64 * 65, 96, "l2", 1), (64 * 33, 32, "nll", 2),
                                        (64 * 65, 128, "huber", 1), (262144, 96, "l2", 1)])
def test_final_head_depth_loss_f32_bwd_sequence_kernels(dev, no_tf32, T, C, kind, F):
    """Each step of the f32 K9's launch sequence against its plain twin, run in f32: the
    tile kernel (dx and the partial rows [dWe | dWh | dgamma | dbeta] on its grid) and
    ``reduce_rows``, each on the kernel's own input; and K9 is the two steps composed,
    bit for bit."""
    gen = torch.Generator().manual_seed(T + C + F + 5)
    p = 4
    args = _depth_args_f32(gen, dev, T, C, F, p)
    kw = dict(patch_size=p, loss_kind=kind, huber_delta=0.5)
    scale = torch.tensor(1.3, device=dev) / torch.isfinite(args[5]).sum()
    dx, part = fh.final_head_depth_loss_bwd_rows(*args, scale, **kw)
    assert dx.dtype == part.dtype == torch.float32
    grid = part.shape[0]
    assert 1 <= grid <= -(-T // fh.TAIL_TILE_ROWS)
    _assert_grads_close((dx, part), fh.final_head_depth_loss_bwd_rows_f32_plain(
        *args, scale, **kw, grid=grid), tol=F32_TOL)
    red = fh.reduce_rows(part)
    _assert_grads_close((red,), (fh.reduce_rows_plain(part),), tol=F32_TOL)
    whole = fh.final_head_depth_loss_bwd(*args, scale, **kw)
    assert all(torch.equal(a, b)
               for a, b in zip(whole, (dx,) + fh.split_f32_bwd_row(red, C, F, p)))


def test_final_head_depth_loss_f32_l1_dbeta_at_the_paper_tail(dev, no_tf32):
    """The l1 loss at the paper tail with targets N(1, 1) above logits near 0: dlogits
    share their sign on most rows, so dbeta is a sum whose terms share a sign; the f32
    K9's sums over 16-row blocks keep it, and every gradient, within 1e-5."""
    gen = torch.Generator().manual_seed(64)
    args = list(_depth_args_f32(gen, dev, 262144, 96, 1))
    args[4] = args[4] / 3  # logits of std ~1 against targets N(1, 1)
    args[5] = torch.where(torch.isfinite(args[5]), args[5] + 1.0, args[5])
    kw = dict(patch_size=4, loss_kind="l1")
    scale = torch.tensor(1.0, device=dev) / torch.isfinite(args[5]).sum()
    got = fh.final_head_depth_loss_bwd(*args, scale, **kw)
    _assert_grads_close(got, fh.final_head_depth_loss_bwd_plain(*args, scale, **kw),
                        tol=F32_TOL)


@pytest.mark.parametrize("T,C,kind,F", [(64 * 65, 32, "l2", 1), (64 * 65, 96, "nll", 2),
                                        (64 * 33, 128, "l2", 2), (262144, 96, "l2", 1)])
def test_final_head_depth_loss_f32_bwd_recomputes_the_forward_logits(dev, no_tf32, T, C,
                                                                     kind, F):
    """The f32 K9's row kernel recomputes the f32 K8's logits bit for bit (both logits
    taps, ``torch.equal``); K8's predictions are its tap; both within 1e-5 of the plain
    version's logits."""
    gen = torch.Generator().manual_seed(T + C + 6)
    p = 4
    args = _depth_args_f32(gen, dev, T, C, F, p)
    kw = dict(patch_size=p, loss_kind=kind)
    _, _, preds, lf8 = fh.final_head_depth_loss_sums(*args, **kw, tap_logits=True)
    lf9 = fh.final_head_depth_loss_bwd_rows(*args, torch.tensor(1.0, device=dev), **kw,
                                            tap_logits=True)[-1]
    assert lf8.shape == (T, p, F) and lf8.dtype == torch.float32
    assert int((lf8 != 0).sum()) > T * p * F // 2
    assert torch.equal(lf8, lf9)
    assert torch.equal(preds, lf8.reshape(T, p * F))
    assert _rel_l2(lf8, fh.final_head_logits_plain(*args[:5], patch_size=p)) < F32_TOL


def test_final_head_depth_loss_f32_function_backward_through_kernels(dev):
    """``final_head_depth_loss`` on f32 tokens: the f32 K8 forward, the f32 K9 backward,
    f32 predictions without a gradient, every gradient f32."""
    gen = torch.Generator().manual_seed(63)
    args = list(_depth_args_f32(gen, dev, 64 * 16, 96, 2))
    for i in range(5):
        args[i] = args[i].clone().requires_grad_()
    before = dict(fh.launches)
    loss, preds = fh.final_head_depth_loss(*args, patch_size=4, loss_kind="nll")
    loss.backward()
    torch.cuda.synchronize()
    assert fh.launches["final_head_depth_loss_f32"] == before["final_head_depth_loss_f32"] + 1
    assert (fh.launches["final_head_depth_loss_bwd_f32"]
            == before["final_head_depth_loss_bwd_f32"] + 1)
    assert preds.dtype == torch.float32 and not preds.requires_grad
    for t in args[:5]:
        assert t.grad is not None and t.grad.dtype == torch.float32
        assert torch.isfinite(t.grad).all()


# --- the f32 K1, K2 and K3 (csrc/window_attention_f32.cu, csrc/tail_f32.cuh): the
# forward kernels of the f32 paper configs' eval and predict, held to the plain versions
# in f32 with TF32 off, relative L2 1e-5 (F32_TOL)
def _epi_args_f32(gen, dev, C, T, masked, has_ln):
    return tuple(None if a is None else a.float() if a.dtype == torch.bfloat16 else a
                 for a in _epi_args(gen, dev, C, T, masked, has_ln))


@pytest.mark.parametrize("C", [96, 192, 384])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("has_ln", [False, True])
def test_window_attention_f32_kernels(dev, no_tf32, C, masked, has_ln):
    """The f32 K1 (its launch sequence: qkv product, attention, output product,
    LayerNorm) at the paper's stage widths against its plain version in f32, under
    no_grad, counted as "window_attention_qkv_epi_f32"; two launches bit-equal."""
    gen = torch.Generator().manual_seed(60 + C + masked + 2 * has_ln)
    h, T = C // 32, 64 * 21
    args = _epi_args_f32(gen, dev, C, T, masked, has_ln)
    kw = dict(ws=64, num_heads=h, sm_scale=32 ** -0.5, has_mask=masked)
    key = ("window_attention_qkv_epi_f32", T, C, masked)
    n = wa.launches_by_shape[key]
    with torch.no_grad():
        got = wa.window_attention_qkv_epi(*args, **kw)
        again = wa.window_attention_qkv_epi(*args, **kw)
    torch.cuda.synchronize()
    assert wa.launches_by_shape[key] == n + 2 and got.dtype == torch.float32
    assert _rel_l2(got, wa.window_attention_qkv_epi_plain(*args, **kw)) < F32_TOL
    assert torch.equal(got, again)


@pytest.mark.parametrize("use_cos", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_f32_kernel(dev, no_tf32, use_cos, masked):
    """The f32 K2 at the bottleneck's width (C 768, 24 heads), both flavours, against its
    plain version in f32, counted as "window_attention_f32"."""
    gen = torch.Generator().manual_seed(70 + use_cos + 2 * masked)
    C, h, T = 768, 24, 64 * 9
    qkv, groups, bias, ls = _attn_args(gen, dev, C, T, use_cos)
    qkv = qkv.float()
    kw = dict(ws=64, num_heads=h, use_cos=use_cos, sm_scale=32 ** -0.5, has_mask=masked)
    n = wa.launches["window_attention_f32"]
    with torch.no_grad():
        got = wa.window_attention(qkv, groups if masked else None, bias, ls, **kw)
    torch.cuda.synchronize()
    assert wa.launches["window_attention_f32"] == n + 1 and got.dtype == torch.float32
    want = wa.window_attention_plain(qkv, groups if masked else None, bias, ls, **kw)
    assert _rel_l2(got, want) < F32_TOL


# the f32 K1's products on the paper predict, (M, N, K) = (T, 3C, C) for qkv and (T, C, C)
# for the projection, and M = 64 (mod 128) with an N that is no multiple of the tile (96)
GEMM_F32_SHAPES = [(262144, 288, 96), (65536, 576, 192), (16384, 1152, 384), (262144, 96, 96),
                   (65536, 192, 192), (16384, 384, 384), (64 * 21, 100, 64), (64 * 3, 388, 32)]


@pytest.mark.parametrize("M,N,K", GEMM_F32_SHAPES)
@pytest.mark.parametrize("has_bias", [True, False])
def test_gemm_nn_f32(dev, no_tf32, M, N, K, has_bias):
    """The f32 K1's product step (``gemm_3xtf32_kernel``, 3xTF32 mma.sync) against
    ``torch.matmul`` in f32 with TF32 off, within relative L2 1e-5; two launches
    bit-equal."""
    gen = torch.Generator().manual_seed(M + N + K + has_bias)
    a, b = _randn(gen, dev, M, K), _randn(gen, dev, K, N, std=K ** -0.5)
    bias = _randn(gen, dev, N, std=0.1) if has_bias else None
    got = wa.gemm_nn_f32(a, b, bias)
    again = wa.gemm_nn_f32(a, b, bias)
    torch.cuda.synchronize()
    want = a @ b if bias is None else a @ b + bias
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert _rel_l2(got, want) < F32_TOL
    assert torch.equal(got, again)


@pytest.mark.parametrize("T,C", [(4096, 768), (16384, 384)])
@pytest.mark.parametrize("use_cos", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_f32_core_at_the_clamp(dev, no_tf32, T, C, use_cos, masked):
    """The f32 attention core (``attn_3xtf32_kernel``: f32 K2, and the f32 K1's step 2)
    at the bottleneck and at a stage shape with every logit scale at the clamp (100),
    both flavours, masked and unmasked, within relative L2 1e-5 of the plain version in
    f32; two launches bit-equal."""
    gen = torch.Generator().manual_seed(90 + C + 2 * use_cos + masked)
    h = C // 32
    qkv, groups, bias, _ = _attn_args(gen, dev, C, T, use_cos)
    qkv = qkv.float()
    ls = torch.full((h,), 100.0, device=dev) if use_cos else None
    args = (qkv, groups if masked else None, bias, ls)
    kw = dict(ws=64, num_heads=h, use_cos=use_cos, sm_scale=32 ** -0.5, has_mask=masked)
    with torch.no_grad():
        got = wa.window_attention(*args, **kw)
        again = wa.window_attention(*args, **kw)
    torch.cuda.synchronize()
    assert _rel_l2(got, wa.window_attention_plain(*args, **kw)) < F32_TOL
    assert torch.equal(got, again)


def test_f32_attention_needing_a_gradient_raises(dev):
    """An f32 K1 or K2 call that needs a gradient raises under "auto" and "pallas"
    before any launch, naming its backward (K4, K5, which take bf16) and impl='xla'."""
    gen = torch.Generator().manual_seed(75)
    args = [a if a is None else a.clone().requires_grad_(a.dtype == torch.float32)
            for a in _epi_args_f32(gen, dev, 96, 128, True, True)]
    qkv, _, bias, ls = _attn_args(gen, dev, 768, 128, True)
    qkv = qkv.float().requires_grad_()
    before = dict(wa.launches)
    for impl in ("auto", "pallas"):
        with pytest.raises(ValueError, match="K4 takes bfloat16.*impl='xla'"):
            wa.window_attention_qkv_epi(*args, ws=64, num_heads=3, sm_scale=0.2, impl=impl)
        with pytest.raises(ValueError, match="K5 takes bfloat16.*impl='xla'"):
            wa.window_attention(qkv, None, bias, ls, ws=64, num_heads=24, use_cos=True,
                                sm_scale=0.2, has_mask=False, impl=impl)
    torch.cuda.synchronize()
    assert dict(wa.launches) == before


@pytest.mark.parametrize("T,C,F", [(64 * 65, 32, 16), (64 * 65, 96, 8), (64 * 3, 64, 5),
                                   (64 * 65, 128, 12), (262144, 96, 8)])
def test_final_head_predict_f32_kernel(dev, no_tf32, T, C, F):
    """The f32 K3 at each instantiation: its classes equal the plain version's outside
    near-ties of the f32 logits, its logits tap within 1e-5 of the plain logits and
    ``torch.equal`` to the f32 K6's tap on the same operands (one row kernel), a NaN
    token gives F - 1; probe (i): its classes are ``argmax_lowest`` of its own tap,
    ``torch.equal``.  Counted as "final_head_predict_f32"."""
    gen = torch.Generator().manual_seed(80 + C + F)
    p = 4
    args = list(_loss_args_f32(gen, dev, T, C, F, p))
    args[0][5] = float("nan")
    n = fh.launches["final_head_predict_f32"]
    preds, tap = fh.final_head_predict(*args[:5], patch_size=p, tap_logits=True)
    got = fh.final_head_predict(*args[:5], patch_size=p)
    lf6 = fh.final_head_loss_sums(*args, patch_size=p, tap_logits=True)[3]
    torch.cuda.synchronize()
    assert fh.launches["final_head_predict_f32"] == n + 2
    assert torch.equal(preds, got) and (got[5] == F - 1).all()
    assert torch.equal(fh.argmax_lowest(tap), preds)  # probe (i)
    fine = torch.ones(T, dtype=torch.bool, device=dev)
    fine[5] = False
    assert torch.equal(tap[fine], lf6[fine]) and tap[5].isnan().all()
    lf = fh.final_head_logits_plain(*args[:5], patch_size=p)
    assert _rel_l2(tap[fine], lf[fine]) < F32_TOL
    ok = fine[:, None] & ~_f32_near_ties(args, p)
    assert torch.equal(got[ok], fh.argmax_lowest(lf)[ok])
