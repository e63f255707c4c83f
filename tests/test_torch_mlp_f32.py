"""The float32 forms of K12-K15 (``csrc/mlp_f32.cu``) and their plain steps, on the CPU.

On the card an f32 x sends the MLP wrappers to the f32 kernels: launch sequences of
3xTF32 products whose new steps have plain twins (``mlp_hidden_plain``, ``mlp_dh_plain``
under ``mlp_dual_plain``, ``mlp_block_ln_plain``, ``mlp_block_ln_bwd_plain``).  Here, on the same numpy inputs:

- (a) the f32 operand path: with ``use_kernel`` forced and the library stubbed, f32
  operands reach the f32 entry with x, the weights and the gradients kept in f32 (bf16
  ones the bf16 entry), counted under the "_f32" keys; float16 and float64 raise,
  naming "bfloat16 or float32", before any launch.  The f32 K13 and K15 hand their
  entries one weight-gradient buffer [dW2 | dW1] and return views of it; the dual
  product's and the wgmma core's own entries (``mlp_dual``, ``gemm_wg_f32``) get their
  workspace and f32 operands, and refuse what they do not take before a launch.
- (b) each new plain step (the dual product's twin ``mlp_dual_plain`` among them)
  against the Pallas kernels of ``heal_swin_tpu/ops/mlp.py`` in interpret mode at float32 (``fused_mlp(..., interpret=True)``, ``fused_mlp_block(...,
  interpret=True)`` and their ``jax.vjp``), through the outputs it feeds: outputs within
  1e-5, gradients within 2e-4, normalized by the largest entry for the branch's (the
  tolerances of ``tests/test_torch_mlp.py``: the same f32 math in another order).
- (c) the slice as a whole: a small HEAL-SWIN model (C 32 and 64) in f32 with dropout 0
  and every block's ``Mlp`` on ``mlp_impl="fused"`` (K13's plain version in each
  backward) against the same weights on "xla" and against the JAX model the converter
  carried them from: loss rtol 1e-5, every gradient within 2e-4 of its largest entry.
- (d) the kernels' 3xTF32 products emulated (``ops/tf32.py``) on an fc1 -> GELU -> fc2
  chain and its dx at C 96 meet 1e-5 of float64 (relative L2) where one TF32 pass does
  not.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch import _build
from heal_swin_torch.convert import state_dict_from_flax
from heal_swin_torch.models import layers as tl
from heal_swin_torch.models import swin_hp as tsh
from heal_swin_torch.ops import mlp as tm
from heal_swin_torch.ops import tf32
from heal_swin_tpu.ops import mlp as jm
from tests.test_torch_train_step import _batch, _cfg_kwargs, _tasks

F32_TOL = 1e-5
F32_GRAD_TOL = 2e-4
MIXED_TOL = 1e-5  # (d): 3xTF32 against float64, relative L2
SHAPES = [(128, 32, 128), (64, 96, 384), (128, 64, 96)]  # (T, C, H)


def _operands(T, C, H, seed):
    """x, w1, b1, w2, b2, gamma, beta, dz (T, C) and a DropPath scale ds (T, 1), f32
    numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(x=rng.normal(size=(T, C)).astype(f),
                w1=(rng.normal(size=(C, H)) * C ** -0.5).astype(f),
                b1=(rng.normal(size=H) * 0.1).astype(f),
                w2=(rng.normal(size=(H, C)) * H ** -0.5).astype(f),
                b2=(rng.normal(size=C) * 0.1).astype(f),
                gam=(1.0 + 0.3 * rng.normal(size=C)).astype(f),
                bet=(0.2 * rng.normal(size=C)).astype(f),
                dz=rng.normal(size=(T, C)).astype(f),
                ds=rng.choice([0.0, 1.25], size=(T, 1)).astype(f))


MLP = ("x", "w1", "b1", "w2", "b2")
BLOCK = MLP + ("gam", "bet")


def _jt(ops, names):
    return ([jnp.asarray(ops[n]) for n in names], [torch.from_numpy(ops[n]) for n in names])


def _close(got, want, name, tol=F32_TOL, normalize=False):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy().reshape(want.shape)
    assert np.isfinite(got).all(), name
    scale = np.abs(want).max() + 1e-12 if normalize else 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol, err_msg=name)


# ------------------------------------------------------------ (a) the f32 operand path
class _Lib:
    """The kernels' library stubbed: each entry records its name and returns 0 (a
    workspace of 0 bytes, a launch without error)."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        def entry(*args):
            self.called.append(name)
            return 0
        return entry


@pytest.fixture
def stubbed(monkeypatch):
    """``use_kernel`` forced true, the device check and the stream off, the library
    stubbed, and the tensors each entry is handed recorded (``_ptrs``)."""
    lib, handed = _Lib(), []
    monkeypatch.setattr(tm, "use_kernel", lambda t, impl: impl != "xla")
    monkeypatch.setattr(tm, "_on_card", lambda what, ops, x: None)
    monkeypatch.setattr(tm, "stream", lambda t: 0)
    monkeypatch.setattr(_build, "lib", lambda: lib)

    def ptrs(ts):
        handed.append(list(ts))
        return [0] * len(ts)

    monkeypatch.setattr(tm, "_ptrs", ptrs)
    return lib, handed


def _entry_args(dtype, seed=0):
    ops = _operands(128, 32, 128, seed)
    t = {k: torch.from_numpy(v) for k, v in ops.items()}
    for k in ("x", "w1", "w2", "dz"):
        t[k] = t[k].to(dtype)
    a5 = [t[k] for k in MLP]
    kw = dict(approximate=True)
    return {"mlp_fwd": lambda: tm.mlp_fwd(*a5, **kw),
            "mlp_bwd": lambda: tm.mlp_bwd(*a5, t["dz"], **kw),
            "mlp_block_fwd": lambda: tm.mlp_block_fwd(*a5, t["gam"], t["bet"], t["ds"], **kw),
            "mlp_block_bwd": lambda: tm.mlp_block_bwd(*a5, t["gam"], t["bet"], t["ds"], t["dz"],
                                                      **kw)}


ENTRIES = ["mlp_fwd", "mlp_bwd", "mlp_block_fwd", "mlp_block_bwd"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("what", ENTRIES)
def test_operands_reach_the_launch_in_their_dtype(stubbed, what, dtype):
    """An f32 x reaches the f32 entry ("hs_<kernel>_f32") with x, W1, W2 and the output
    gradient handed over in f32, the biases and LayerNorm parameters in f32, counted
    under "<kernel>_f32"; a bf16 x the bf16 entry with bf16 weights, as before."""
    lib, handed = stubbed
    sfx = "_f32" if dtype == torch.float32 else ""
    before = dict(tm.launches)
    _entry_args(dtype)[what]()
    launched = [n for n in lib.called if not n.endswith("_workspace")]
    assert launched == [f"hs_{what}{sfx}"]
    ops = handed[-1]
    assert [t.dtype for t in ops[:5]] == [dtype, dtype, torch.float32, dtype, torch.float32]
    if what == "mlp_bwd":
        assert ops[5].dtype == dtype  # dout
    if what.startswith("mlp_block"):
        assert ops[5].dtype == ops[6].dtype == torch.float32  # gamma, beta
        assert ops[7].dtype == torch.float32  # dscale
    if what == "mlp_block_bwd":
        assert ops[8].dtype == dtype  # dz
    assert {k: tm.launches[k] - before[k] for k in before if tm.launches[k] != before[k]} \
        == {what + sfx: 1}


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64], ids=["float16", "float64"])
@pytest.mark.parametrize("what", ENTRIES + ["Mlp"])
def test_other_dtypes_raise_before_a_launch(stubbed, what, dtype):
    """float16 and float64 raise, naming what the kernels take, before any entry is
    called; the fused gate of ``Mlp`` raises at the call, not in the backward."""
    lib, _ = stubbed
    before = dict(tm.launches)
    if what == "Mlp":
        mod = tl.Mlp(32, 128, 32, mlp_impl="fused").to(dtype)
        call = functools.partial(mod, torch.randn(2, 64, 32, dtype=dtype))
    else:
        call = _entry_args(dtype)[what]
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        call()
    assert lib.called == [] and tm.launches == before


def test_f32_gradient_must_match_x(stubbed):
    """An f32 x with a bf16 output gradient raises, naming float32."""
    lib, _ = stubbed
    ops = {k: torch.from_numpy(v) for k, v in _operands(128, 32, 128, 1).items()}
    with pytest.raises(ValueError, match="float32"):
        tm.mlp_bwd(*[ops[k] for k in MLP], ops["dz"].bfloat16(), approximate=False)
    assert [n for n in lib.called if not n.endswith("_workspace")] == []


@pytest.mark.parametrize("what", ["mlp_bwd", "mlp_block_bwd"])
def test_f32_backwards_hand_one_weight_gradient_buffer(stubbed, what):
    """The f32 K13 and K15 entries get one buffer of 2 C H floats for the weight
    gradients (their TN pair's reduction writes [dW2 (H, C) | dW1 (C, H)]) and a [db1 |
    db2 ...] row, and the wrapper returns views of them in its own order."""
    lib, handed = stubbed
    T, C, H = 128, 32, 128
    out = _entry_args(torch.float32)[what]()
    ops = handed[-1]
    dw, red = (ops[7], ops[8]) if what == "mlp_bwd" else (ops[10], ops[11])
    assert dw.numel() == 2 * C * H and red.numel() == H + (1 if what == "mlp_bwd" else 3) * C
    dw1, db1, dw2 = out[1], out[2], out[3]
    assert tuple(dw1.shape) == (C, H) and tuple(dw2.shape) == (H, C)
    assert dw2.data_ptr() == dw.data_ptr()
    assert dw1.data_ptr() == dw.data_ptr() + 4 * C * H
    assert db1.data_ptr() == red.data_ptr()


@pytest.fixture
def stubbed_rows(stubbed, monkeypatch):
    """``stubbed`` with the step wrappers' operand check taking CPU tensors."""
    def rows(what, t, T, C):
        if t.dtype != torch.float32 or tuple(t.shape) != (T, C):
            raise ValueError(f"{what}: expected a (T, C) = {(T, C)} float32 tensor")
        return t.contiguous()

    monkeypatch.setattr(tm, "_f32_rows", rows)
    return stubbed


def test_dual_step_reaches_its_entry(stubbed_rows):
    """``mlp_dual`` hands x, W1, b1, W2 and dout in f32 to "hs_mlp_dual_f32" with its
    workspace, and counts no launch; float64 or a bf16 dout raise before the entry."""
    lib, handed = stubbed_rows
    t = {k: torch.from_numpy(v) for k, v in _operands(128, 32, 128, 3).items()}
    before = dict(tm.launches)
    g, dh, db1, db2 = tm.mlp_dual(t["x"], t["w1"], t["b1"], t["w2"], t["dz"], approximate=False)
    assert lib.called == ["hs_mlp_dual_f32_workspace", "hs_mlp_dual_f32"]
    assert [o.dtype for o in handed[-1][:5]] == [torch.float32] * 5
    assert tuple(g.shape) == tuple(dh.shape) == (128, 128) and db1.numel() == 128
    assert db2.numel() == 32 and tm.launches == before
    for bad in (lambda: tm.mlp_dual(t["x"].double(), t["w1"], t["b1"], t["w2"], t["dz"],
                                    approximate=False),
                lambda: tm.mlp_dual(t["x"], t["w1"], t["b1"], t["w2"], t["dz"].bfloat16(),
                                    approximate=False)):
        with pytest.raises(ValueError, match="float32"):
            bad()
    assert lib.called == ["hs_mlp_dual_f32_workspace", "hs_mlp_dual_f32"]


@pytest.mark.parametrize("layout", ["nn", "nt", "tn"])
def test_core_product_reaches_its_entry(stubbed_rows, layout):
    """``gemm_wg_f32`` hands both operands and an (M, N) output to "hs_gemm_wg_f32" with
    its layout's code (0 NN, 1 NT, 2 TN) after its workspace; shapes it does not take (K
    not a multiple of 32, M or N not of 4, disagreeing K) raise before the entry."""
    lib, handed = stubbed_rows
    M, N, K = 64, 96, 160
    a = torch.zeros((K, M) if layout == "tn" else (M, K))
    b = torch.zeros((N, K) if layout == "nt" else (K, N))
    out = tm.gemm_wg_f32(a, b, layout)
    assert lib.called == ["hs_gemm_wg_f32_workspace", "hs_gemm_wg_f32"]
    assert tuple(out.shape) == (M, N) and handed[-1][2] is out
    bad_k = torch.zeros((K + 8, M) if layout == "tn" else (M, K + 8))
    bad_n = torch.zeros((N + 2, K) if layout == "nt" else (K, N + 2))
    for x, y in ((bad_k, b), (a, bad_n)):
        with pytest.raises(ValueError, match="gemm_wg_f32"):
            tm.gemm_wg_f32(x, y, layout)
    assert lib.called == ["hs_gemm_wg_f32_workspace", "hs_gemm_wg_f32"]


def test_step_wrappers_run_their_plain_twins_on_the_cpu():
    """On CPU tensors the f32 sequences' step wrappers are their plain twins, count no
    launch, and demand the kernel with impl="pallas"."""
    ops = {k: torch.from_numpy(v) for k, v in _operands(128, 32, 128, 2).items()}
    x, w1, b1, w2, b2, g, b, dz, ds = (ops[k] for k in BLOCK + ("dz", "ds"))
    gg = tm.mlp_hidden_plain(x, w1, b1, approximate=True)[1]
    u = gg @ w2 + b2
    before = dict(tm.launches)
    pairs = (
        (lambda **k: (tm.mlp_hidden(x, w1, b1, approximate=True, **k),), (gg,)),
        (lambda **k: (tm.mlp_block_ln(u, x, g, b, ds, **k),),
         (tm.mlp_block_ln_plain(u, x, g, b, ds),)),
        (lambda **k: tm.mlp_block_ln_bwd(u, dz, g, ds, **k),
         tm.mlp_block_ln_bwd_plain(u, dz, g, ds)))
    pairs += (
        (lambda **k: tm.mlp_dual(x, w1, b1, w2, dz, approximate=True, **k),
         tm.mlp_dual_plain(x, w1, b1, w2, dz, approximate=True)),
        (lambda **k: (tm.gemm_wg_f32(x, w1, "nn", **k),), (x @ w1,)),
        (lambda **k: (tm.gemm_wg_f32(dz, w2, "nt", **k),), (dz @ w2.t(),)),
        (lambda **k: (tm.gemm_wg_f32(x, dz, "tn", **k),), (x.t() @ dz,)))
    for call, want in pairs:
        assert all(torch.equal(a, w) for a, w in zip(call(), want))
        with pytest.raises(ValueError, match="pallas"):
            call(impl="pallas")
    assert tm.launches == before


# -------------------------------------- (b) the plain steps against the Pallas kernels
def _pallas_mlp_vjp(j, dz, approximate):
    """out and (dx, dW1, db1, dW2, db2) of ``fused_mlp`` with the Pallas forward and
    backward in interpret mode."""
    out, vjp = jax.vjp(lambda *a: jm.fused_mlp(*a, approximate=approximate, rblk=16,
                                                interpret=True, fwd_impl="pallas"), *j)
    return out, vjp(jnp.asarray(dz))


def _pallas_block_vjp(j, ds, dz, approximate):
    """z and (dx, dW1, db1, dW2, db2, dgamma, dbeta) of ``fused_mlp_block`` (Pallas
    forward and backward in interpret mode)."""
    ds_j = None if ds is None else jnp.asarray(ds)
    out, vjp = jax.vjp(lambda *a: jm.fused_mlp_block(*a, ds_j, approximate=approximate,
                                                      rblks=(32, 16), interpret=True), *j)
    return out, vjp(jnp.asarray(dz))


@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("T,C,H", SHAPES)
def test_hidden_plain_feeds_the_pallas_forward(T, C, H, approximate):
    """The f32 sequences' first step: g of ``mlp_hidden_plain``, through g W2 + b2 (the
    second step), is the Pallas forward's output; h is x W1 + b1 and g = GELU(h)."""
    ops = _operands(T, C, H, seed=T + C + H)
    j, t = _jt(ops, MLP)
    out, _ = _pallas_mlp_vjp(j, ops["dz"], approximate)
    x, w1, b1, w2, b2 = t
    h, g = tm.mlp_hidden_plain(x, w1, b1, approximate=approximate)
    assert h.dtype == g.dtype == torch.float32 and tuple(h.shape) == (T, H)
    _close(g @ w2 + b2, out, "out")
    _close(h, jnp.dot(j[0], j[1]) + j[2], "h")
    _close(g, jax.nn.gelu(jnp.dot(j[0], j[1]) + j[2], approximate=approximate), "g")


@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("T,C,H", SHAPES)
def test_dh_plain_feeds_the_pallas_backward(T, C, H, approximate):
    """The f32 K13's GELU-gradient step: dh = ``mlp_dh_plain`` gives, through the
    sequence's other steps (dh W1^T, x^T dh, the sum of dh, g^T dout, the sum of dout),
    the Pallas backward's dx, dW1, db1, dW2 and db2."""
    ops = _operands(T, C, H, seed=T + C + H + 1)
    j, t = _jt(ops, MLP)
    _, want = _pallas_mlp_vjp(j, ops["dz"], approximate)
    x, w1, b1, w2, _ = t
    dout = torch.from_numpy(ops["dz"])
    h, g = tm.mlp_hidden_plain(x, w1, b1, approximate=approximate)
    dh = tm.mlp_dh_plain(h, w2, dout, approximate=approximate)
    got = (dh @ w1.t(), x.t() @ dh, dh.sum(0), g.t() @ dout, dout.sum(0))
    for name, a, w in zip(("dx", "dW1", "db1", "dW2", "db2"), got, want):
        _close(a, w, name, tol=F32_GRAD_TOL)


@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("T,C,H", SHAPES)
def test_dual_plain_feeds_the_pallas_backward(T, C, H, approximate):
    """The f32 K13's dual product in one plain step: g, dh, db1 and db2 of
    ``mlp_dual_plain`` give, through the sequence's other steps (dh W1^T, x^T dh, g^T
    dout), the Pallas backward's dx, dW1, db1, dW2 and db2; g is GELU(x W1 + b1)."""
    ops = _operands(T, C, H, seed=T + C + H + 2)
    j, t = _jt(ops, MLP)
    _, want = _pallas_mlp_vjp(j, ops["dz"], approximate)
    x, w1, b1, w2, _ = t
    dout = torch.from_numpy(ops["dz"])
    g, dh, db1, db2 = tm.mlp_dual_plain(x, w1, b1, w2, dout, approximate=approximate)
    assert g.dtype == dh.dtype == torch.float32 and tuple(dh.shape) == (T, H)
    got = (dh @ w1.t(), x.t() @ dh, db1, g.t() @ dout, db2)
    for name, a, w in zip(("dx", "dW1", "db1", "dW2", "db2"), got, want):
        _close(a, w, name, tol=F32_GRAD_TOL)
    _close(g, jax.nn.gelu(jnp.dot(j[0], j[1]) + j[2], approximate=approximate), "g")


@pytest.mark.parametrize("has_dp", [False, True])
@pytest.mark.parametrize("approximate", [True, False])
def test_block_ln_plain_feeds_the_pallas_block_forward(approximate, has_dp):
    """The f32 K14's last step: ``mlp_block_ln_plain`` on u = g W2 + b2 (the first two
    steps) is the Pallas branch's z = x + dscale * LN(u)."""
    ops = _operands(128, 32, 128, seed=11)
    j, t = _jt(ops, BLOCK)
    ds = ops["ds"] if has_dp else None
    out, _ = _pallas_block_vjp(j, ds, ops["dz"], approximate)
    x, w1, b1, w2, b2, gam, bet = t
    _, g = tm.mlp_hidden_plain(x, w1, b1, approximate=approximate)
    z = tm.mlp_block_ln_plain(g @ w2 + b2, x, gam, bet,
                              None if ds is None else torch.from_numpy(ds))
    _close(z, out, "z")


@pytest.mark.parametrize("has_dp", [False, True])
@pytest.mark.parametrize("approximate", [True, False])
def test_block_ln_bwd_plain_feeds_the_pallas_block_backward(approximate, has_dp):
    """The f32 K15's sequence in plain steps: ``mlp_block_ln_bwd_plain``'s db2, dgamma
    and dbeta are the Pallas backward's, and its du through ``mlp_dh_plain`` and the
    products (dz + dh W1^T, x^T dh, the sum of dh, g^T du) gives its dx, dW1, db1 and
    dW2 (normalized by each gradient's largest entry)."""
    ops = _operands(128, 32, 128, seed=12)
    j, t = _jt(ops, BLOCK)
    ds = ops["ds"] if has_dp else None
    _, want = _pallas_block_vjp(j, ds, ops["dz"], approximate)
    x, w1, b1, w2, b2, gam, _ = t
    dz = torch.from_numpy(ops["dz"])
    h, g = tm.mlp_hidden_plain(x, w1, b1, approximate=approximate)
    du, db2, dgam, dbet = tm.mlp_block_ln_bwd_plain(
        g @ w2 + b2, dz, gam, None if ds is None else torch.from_numpy(ds))
    dh = tm.mlp_dh_plain(h, w2, du, approximate=approximate)
    got = (dz + dh @ w1.t(), x.t() @ dh, dh.sum(0), g.t() @ du, db2, dgam, dbet)
    names = ("dx", "dW1", "db1", "dW2", "db2", "dgamma", "dbeta")
    for name, a, w in zip(names, got, want):
        _close(a, w, name, tol=F32_GRAD_TOL, normalize=True)


@pytest.mark.parametrize("approximate", [True, False])
def test_steps_composed_are_the_plain_versions(approximate):
    """The f32 sequences' steps composed as the kernels compose them give the plain
    versions of K13 and K15 (f32, float rounding apart)."""
    ops = _operands(128, 32, 128, seed=13)
    x, w1, b1, w2, b2, gam, bet, dz, ds = (torch.from_numpy(ops[k])
                                           for k in BLOCK + ("dz", "ds"))
    kw = dict(approximate=approximate)
    h, g = tm.mlp_hidden_plain(x, w1, b1, **kw)
    dh = tm.mlp_dh_plain(h, w2, dz, **kw)
    seq = (dh @ w1.t(), x.t() @ dh, dh.sum(0), g.t() @ dz, dz.sum(0))
    for a, w in zip(seq, tm.mlp_bwd_plain(x, w1, b1, w2, b2, dz, **kw)):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)
    du, db2, dgam, dbet = tm.mlp_block_ln_bwd_plain(g @ w2 + b2, dz, gam, ds)
    dh = tm.mlp_dh_plain(h, w2, du, **kw)
    seq = (dz + dh @ w1.t(), x.t() @ dh, dh.sum(0), g.t() @ du, db2, dgam, dbet)
    for a, w in zip(seq, tm.mlp_block_bwd_plain(x, w1, b1, w2, b2, gam, bet, ds, dz, **kw)):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- (c) the slice as a whole
def _grads(task):
    return {n: p.grad.detach().clone() for n, p in task.model.named_parameters()}


def test_model_with_fused_mlp_matches_xla_and_jax(monkeypatch):
    """A two-stage HEAL-SWIN model (C 32 and 64, the decoder too; the exact GELU of the
    paper configs) in f32, dropout 0, every block's ``Mlp`` on ``mlp_impl="fused"``
    (each block's MLP backward through K13's plain version): loss and every parameter
    gradient against the same weights on "xla" and against the JAX model the converter
    carried them from."""
    kw = dict(_cfg_kwargs(False), embed_dim=32, num_heads=[1, 2])
    jtask, params, ttask = _tasks(kw)
    imgs, targets = _batch(2)

    def jloss(p):
        return jtask.loss_fn(p, jnp.asarray(imgs), jnp.asarray(targets))

    (loss_j, _), grads_j = jax.value_and_grad(jloss, has_aux=True)(params)
    blocks = [m for m in ttask.model.modules() if isinstance(m, tsh.SwinHPBlock)]
    assert len(blocks) == 5

    calls = []
    orig = tm.fused_mlp_nd
    monkeypatch.setattr(tm, "fused_mlp_nd", lambda *a, **k: calls.append(1) or orig(*a, **k))
    losses, grads = {}, {}
    for impl in ("xla", "fused"):
        for blk in blocks:
            blk.mlp.mlp_impl = impl
        ttask.model.zero_grad(set_to_none=True)
        loss, _ = ttask.loss_fn(torch.from_numpy(imgs), torch.from_numpy(targets))
        loss.backward()
        losses[impl], grads[impl] = float(loss.detach()), _grads(ttask)
    assert len(calls) == len(blocks)  # the fused route, once a block
    want = {k: v.numpy()
            for k, v in state_dict_from_flax(jax.tree.map(np.asarray, grads_j)).items()}
    np.testing.assert_allclose(losses["fused"], float(loss_j), rtol=F32_TOL)
    np.testing.assert_allclose(losses["fused"], losses["xla"], rtol=F32_TOL)
    assert set(want) == set(grads["fused"])
    for name, g in grads["fused"].items():
        for ref, label in ((want[name], "jax"), (grads["xla"][name].numpy(), "xla")):
            scale = max(np.abs(ref).max(), 1e-8)
            np.testing.assert_allclose(g.numpy() / scale, ref / scale, atol=F32_GRAD_TOL,
                                       err_msg=f"{name} vs {label}")


# ------------------------------------------------ (d) 3xTF32 on the MLP chain, emulated
def _gelu64(h):
    return 0.5 * h * (1.0 + torch.erf(h / np.sqrt(2.0)))


def _gelu_grad64(h):
    return 0.5 * (1.0 + torch.erf(h / np.sqrt(2.0))) + h * torch.exp(-0.5 * h * h) / np.sqrt(
        2.0 * np.pi)


def _chain(mm, x, w1, b1, w2, b2, dout, gelu, gelu_grad):
    """out = fc2(GELU(fc1 x)) and dx = ((dout W2^T) GELU'(h)) W1^T with products ``mm``."""
    h = mm(x, w1) + b1
    out = mm(gelu(h), w2) + b2
    dx = mm(mm(dout, w2.t()) * gelu_grad(h), w1.t())
    return out, dx


def test_3xtf32_mlp_chain_meets_float64():
    """The f32 K12/K13 products as the tensor cores take them (``ops/tf32.py``): at C 96
    (H 384, T 4,096) 3xTF32 holds out and dx within relative L2 1e-5 of float64 where
    one TF32 pass misses by more than 10x."""
    ops = _operands(4096, 96, 384, seed=14)
    x, w1, b1, w2, b2, dout = (torch.from_numpy(ops[k]) for k in MLP + ("dz",))
    want = _chain(torch.matmul, *(a.double() for a in (x, w1, b1, w2, b2, dout)),
                  _gelu64, _gelu_grad64)

    def f32(mm):
        return _chain(mm, x, w1, b1, w2, b2, dout,
                      functools.partial(tm._gelu_f32, approximate=False),
                      functools.partial(tm._gelu_grad_f32, approximate=False))

    def rel(a, b):
        return float(torch.linalg.vector_norm(a.double() - b) / torch.linalg.vector_norm(b))

    for got, w in zip(f32(tf32.matmul_3xtf32), want):
        assert rel(got, w) < MIXED_TOL
    for got, w in zip(f32(tf32.matmul_tf32), want):
        assert rel(got, w) > 10 * MIXED_TOL


# ------------------------------------------------- the card's bounds of the f32 kernels
@pytest.mark.parametrize("T,C", [(262144, 96), (65536, 192), (16384, 384), (4096, 768)])
@pytest.mark.parametrize("name,gflop", [("mlp_fwd", 38.65), ("mlp_bwd", 96.63),
                                        ("mlp_block_fwd", 38.65), ("mlp_block_bwd", 115.96)])
def test_chip_smoke_works_the_f32_mlp_kernels(name, gflop, T, C):
    """``chip_smoke.shape_work`` of an f32 K12-K15 launch at a stage shape (T C^2 =
    2.416e9 at every stage, so every stage costs the same): the bf16 form's FLOPs (2,
    5, 2 and 6 products of 2 T C H), and its bytes with the tokens and weights at 4
    bytes (x and the output, or x, the output gradient and dx; W1 and W2)."""
    import chip_smoke

    H = 4 * C
    key = (T, C, H, False) + ((True,) if name.startswith("mlp_block") else ())
    flop, nbytes = chip_smoke.shape_work((name + "_f32",) + key)
    flop16, nbytes16 = chip_smoke.shape_work((name,) + key)
    assert flop == flop16 and abs(flop / 1e9 - gflop) < 0.01
    tokens = 2 if "fwd" in name else 3
    assert nbytes - nbytes16 == 2 * tokens * T * C + 4 * C * H
