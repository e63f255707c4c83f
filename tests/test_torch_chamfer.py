"""heal_swin_torch Chamfer folds on the CPU: the plain versions of K10 (brute) and K11
(pruned) against the JAX package's Pallas kernels in interpret mode and against each
other.

The contract of the port: every distance is (dx*dx + dy*dy) + dz*dz with one f32
rounding per operation, so the per-point minima of the brute and the pruned routes
are bit-equal (a min is exact and takes no order) and so are their scalars (both
reduce with ``chamfer._means``).  XLA's CPU backend, which runs the Pallas kernel in
interpret mode, contracts the two additions into FMAs, d = fma(dz, dz, fma(dx, dx,
dy*dy)); the port's minima therefore sit within 2 ulp of the interpreted kernel's
(measured: 2) and are bit-equal to numpy's separately rounded expression.  The
scalars agree with the JAX package's to 1e-6 relative (f32 summation order).
"""

import numpy as np
import pytest
import torch

from heal_swin_torch.ops import chamfer as tch
from heal_swin_torch.ops import chamfer_pruned as tchp
from heal_swin_tpu.ops import chamfer as jch
from heal_swin_tpu.ops import chamfer_pruned as jchp
from tests.test_chamfer_pruned import _clouds

REL = 1e-6


def _pair(n, m, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(n, 3)) * 5).astype(np.float32),
            (rng.normal(size=(m, 3)) * 5 - 1).astype(np.float32))


def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())


def _pallas_minima(p, q):
    """The Pallas brute kernel's per-point minima of the valid points, interpreted."""
    n, m = len(p), len(q)
    bp, bq = jch._bucket(n), jch._bucket(m)
    pp = np.zeros((bp, 3), np.float32)
    pp[:n] = p
    qp = np.zeros((bq, 3), np.float32)
    qp[:m] = q
    pv = (np.arange(bp) < n).astype(np.float32).reshape(bp, 1)
    qv = (np.arange(bq) < m).astype(np.float32).reshape(1, bq)
    pc, qc = jch._make_min_both(bp, bq, jch._PT, jch._QT, True)(pp, qp.T.copy(), pv, qv)
    scalar = float(jch.chamfer_distance_masked_pallas(pp, qp, pv[:, 0] > 0, qv[0] > 0,
                                                      interpret=True))
    return np.asarray(pc)[:n, 0], np.asarray(qc).reshape(-1)[:m], scalar


def _separately_rounded_minima(p, q):
    dx = p[:, None, 0] - q[None, :, 0]
    dy = p[:, None, 1] - q[None, :, 1]
    dz = p[:, None, 2] - q[None, :, 2]
    d = (dx * dx + dy * dy) + dz * dz
    return d.min(1), d.min(0)


@pytest.mark.parametrize("n,m", [(3000, 2500), (700, 4100)])
def test_min_both_plain_matches_pallas_interpret(n, m):
    p, q = _pair(n, m)
    pm, qm = (t.numpy() for t in tch.chamfer_min_both_plain(torch.from_numpy(p),
                                                            torch.from_numpy(q)))
    want_p, want_q = _separately_rounded_minima(p, q)
    assert pm.tobytes() == want_p.tobytes() and qm.tobytes() == want_q.tobytes()
    jp, jq, scalar = _pallas_minima(p, q)
    assert _ulps(pm, jp) <= 2 and _ulps(qm, jq) <= 2
    got = tch.chamfer_distance(p, q, route="brute", device="cpu")
    assert abs(got - scalar) <= REL * abs(scalar)


def test_min_both_plain_masks_by_count():
    """Rows beyond the valid counts stay +inf and take part in no minimum, whatever
    their coordinates."""
    p, q = _pair(300, 200, seed=1)
    p[250:] = q[0]  # padding placed on a valid q point would win if it were counted
    q[150:] = p[0]
    pm, qm = tch.chamfer_min_both_plain(torch.from_numpy(p), torch.from_numpy(q), 250, 150)
    want_p, want_q = _separately_rounded_minima(p[:250], q[:150])
    assert pm[:250].numpy().tobytes() == want_p.tobytes()
    assert qm[:150].numpy().tobytes() == want_q.tobytes()
    assert torch.isinf(pm[250:]).all() and torch.isinf(qm[150:]).all()
    pm0, qm0 = tch.chamfer_min_both_plain(torch.from_numpy(p), torch.from_numpy(q), 0, 150)
    assert torch.isinf(pm0).all() and torch.isinf(qm0).all()


@pytest.mark.parametrize("name", ["uniform", "clustered", "lattice", "tiny_asym",
                                  "identical"])
def test_pruned_minima_bit_equal_brute(name):
    """The pruned pipeline (plain K11) against the brute plain version on the five
    cloud families of the JAX package's pruning tests: every per-point minimum and
    the scalar bit-equal."""
    p, q = _clouds()[name]
    pruned, brute = {}, {}
    vp = tch.chamfer_distance(p, q, route="pruned", device="cpu", stats=pruned)
    vb = tch.chamfer_distance(p, q, route="brute", device="cpu", stats=brute)
    assert pruned["route"] == "pruned" and brute["route"] == "brute"
    for key in ("d_pq", "d_qp"):
        assert pruned[key].tobytes() == brute[key].tobytes(), (
            f"{name}/{key}: {np.count_nonzero(pruned[key] != brute[key])} minima differ")
    assert np.float32(vp).tobytes() == np.float32(vb).tobytes()
    assert pruned["dense_pairs"] == -(-len(p) // 1024) * -(-len(q) // 1024)


def test_pruned_matches_jax_pruned():
    """The port's pruned scalar and prune statistics against the JAX pipeline's, its
    fold interpreted: the host half is the same, so are the pair lists."""
    p, q = _clouds()["clustered"]
    p, q = p[::4][:2500], q[::4][:3000]
    js, ts = {}, {}
    want = jchp.chamfer_distance_pruned(p, q, interpret=True, stats=js)
    got = tch.chamfer_distance(p, q, route="pruned", device="cpu", stats=ts)
    assert abs(got - want) <= REL * abs(want)
    assert ts["round_pairs"] == js["round_pairs"] and ts["final_pairs"] == js["final_pairs"]
    assert ts["work_frac"] == js["work_frac"]


def test_fold_pairs_plain_masks_padding_by_count():
    """An all-padding tile folds nothing; a side under one tile folds its valid points
    only; the minima merge into what they held before."""
    rng = np.random.default_rng(2)
    T = tchp._TP
    ptab = torch.from_numpy(rng.normal(size=(2, 3, T)).astype(np.float32))
    qtab = torch.from_numpy(rng.normal(size=(1, 3, T)).astype(np.float32))
    n, m = 700, 300  # p tile 1 is all padding; q under one tile
    pmin = torch.full((2 * T,), float("inf"))
    qmin = torch.full((T,), float("inf"))
    pairs = torch.tensor([[0, 0], [1, 0]], dtype=torch.int32)
    tchp.chamfer_fold_pairs(pairs, ptab, qtab, n, m, pmin, qmin)
    p = ptab[0].t()[:n].contiguous()
    q = qtab[0].t()[:m].contiguous()
    want_p, want_q = tch.chamfer_min_both_plain(p, q)
    assert torch.equal(pmin[:n], want_p) and torch.equal(qmin[:m], want_q)
    assert torch.isinf(pmin[n:]).all() and torch.isinf(qmin[m:]).all()
    # a second fold of the same pairs changes nothing; an earlier smaller value stays
    pmin[3] = 0.0
    tchp.chamfer_fold_pairs(pairs, ptab, qtab, n, m, pmin, qmin)
    assert float(pmin[3]) == 0.0 and torch.equal(pmin[4:n], want_p[4:])


def test_empty_side_gives_nan():
    empty, five = np.zeros((0, 3), np.float32), np.ones((5, 3), np.float32)
    for route in (None, "brute", "pruned"):
        assert np.isnan(tch.chamfer_distance(empty, five, route=route, device="cpu"))
        assert np.isnan(tch.chamfer_distance(five, empty, route=route, device="cpu"))
    assert tch.prepare_pair(empty, five, "pruned") is None
    assert np.isnan(tchp.chamfer_distance_pruned(empty, five, device="cpu"))


def test_route_rule():
    assert tch._impl(500_000, 500_000) == "pruned"  # 2.5e11 pairs
    assert tch._impl(499_999, 500_000) == "brute"
    assert tch._impl(10, 10, "pruned") == "pruned"
    with pytest.raises(ValueError, match="unknown route"):
        tch._impl(10, 10, "pallas")
    p, q = _pair(40, 50)
    assert tch.prepare_pair(p, q) is None  # brute by the rule: no host prep
    assert tch.prepare_pair(p, q, "pruned").n == 40


def test_caches_bounded_and_cleared():
    """Host prep and device tables are cached by content, the same table serves
    either role, both caches stay within their bound, and clear() empties them."""
    tchp.clear()
    p, q = _pair(2100, 1700, seed=3)
    pr = tchp.chamfer_prepare(p, q)
    v1 = tchp.chamfer_distance_pruned(p, q, device="cpu", prepared=pr)
    assert len(tchp._SIDE_CACHE) == 2 and len(tchp._DEVICE_CACHE) == 2
    tab = tchp._device_side(pr.pkey, pr.ps, pr.rank_p, pr.n, "cpu")[0]
    assert tchp.chamfer_distance_pruned(np.array(p), np.array(q), device="cpu") == v1
    assert tchp._device_side(pr.pkey, pr.ps, pr.rank_p, pr.n, "cpu")[0] is tab
    tchp.chamfer_distance_pruned(q, p, device="cpu")  # the same two sides, roles swapped
    assert len(tchp._DEVICE_CACHE) == 2
    rng = np.random.default_rng(4)
    for _ in range(tchp._CACHE_MAX + 2):
        tchp.chamfer_distance_pruned(rng.normal(size=(1100, 3)).astype(np.float32), q,
                                     device="cpu")
    assert len(tchp._SIDE_CACHE) <= tchp._CACHE_MAX
    assert len(tchp._DEVICE_CACHE) <= tchp._CACHE_MAX
    tchp.clear()
    assert not tchp._SIDE_CACHE and not tchp._DEVICE_CACHE
