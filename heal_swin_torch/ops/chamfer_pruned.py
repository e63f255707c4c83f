"""Exact neighbour-pruned Chamfer distance: the host half and the pruned fold (K11)
(counterpart of ``heal_swin_tpu/ops/chamfer_pruned.py``).

The pipeline skips tile pairs whose bounding-box lower bound proves that no distance
between them can beat the running minima of the points they cover; every distance it
does compute is the brute fold's expression (``ops/chamfer.py``), so the per-point
minima and the scalar are bit-equal to the brute route.

1. Host: Morton-sort both clouds, so that neighbouring points share a 1024-point tile;
   pad each sorted cloud to its bucket by repeating its last point; tile bounding
   boxes and the (tiles x tiles) box lower bounds ``lb``.
2. Tightening rounds (``_ROUNDS``): each tile folds its nearest boxes through K11;
   the per-tile upper bounds (the largest running minimum of a tile's valid points)
   come back after each round and prune the next round's candidates.
3. Prune: keep (i, j) only if ``lb(i, j) < ub_p(i) * _MARGIN`` or ``< ub_q(j) *
   _MARGIN``; the relative margin covers the few ulp of rounding in both the f32
   distance and the f32 box bound.
4. Fold the survivors through K11, gather the minima back to the original order and
   reduce them with ``chamfer._means``.

The host half (``_morton_order``, ``_box_lb``, ``_pad_tiles``, ``_prepare_side``,
``_nearest_pairs``, ``_ROUNDS``, ``_MARGIN``) is the JAX package's, unchanged, so the
pair lists and the prune statistics are the same.  What the JAX package did for
Mosaic is not here: K11 takes the pair list as it is, one (p-tile, q-tile) pair per
block, so there is no packing of operands, no row grouping and no padding of the row
tables to compiled-shape buckets.

Tables: each side's sorted, padded cloud lives on the device as (tiles, 3, 1024) f32,
coordinate-major within a tile, the same layout for either role.  The host prep of a
side and its device table are cached by content (the writer's four variants share
their prediction cloud); both caches are bounded and ``clear()`` empties them.  Only
the thread that folds uploads, so a worker thread that prepares the next pair issues
no CUDA work.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import Counter
from typing import NamedTuple, Optional

import numpy as np
import torch

from heal_swin_torch import _build
from heal_swin_torch.ops import chamfer as ch
from heal_swin_torch.ops._dispatch import check, default_device, stream, use_kernel

_TP = 1024  # p-tile points
_TQ = 1024  # q-tile points
assert _TP == _TQ  # _prepare_side shares one tiling for both sides

# Above this the dense lower-bound matrix and tile tables outgrow the host prep.
_MAX_POINTS = 4 * 1024 * 1024

# Tightening rounds: cumulative nearest-tile counts per tile.  Every point's true-NN
# tile survives every prune (its lower bound <= the point's true min <= the tile
# bound), so the minima are exact under any schedule; the schedule only sets how
# tight the bounds are before the final sweep.  (4, 16) is the JAX package's, chosen
# in its real eval writer.
_ROUNDS = (4, 16)

# Conservative pruning slack, relative: the f32 distance and the f32 box lower bound
# are each within a few ulp, so a pruned pair's distance is >= lb / _MARGIN > ub >=
# every covered running minimum.  (1e-5 covers ~84 ulp.)
_MARGIN = 1.0 + 1e-5

# the plain fold's tile pairs per step: 4 (1024 x 1024) f32 blocks, 16 MiB each
_PLAIN_PAIRS_PER_STEP = 4

# the side caches: host prep and device tables, by content hash
_CACHE_MAX = 8
_SIDE_CACHE: dict = {}
_DEVICE_CACHE: dict = {}
_LOCK = threading.Lock()

# launch counters, bumped only where the kernel launches: per kernel, and per
# (kernel, folded tile pairs)
launches = {"chamfer_fold_pairs": 0}
launches_by_shape: Counter = Counter()


def clear() -> None:
    """Empty both side caches: no host prep and no device table stays behind."""
    with _LOCK:
        _SIDE_CACHE.clear()
        _DEVICE_CACHE.clear()


def _put(cache: dict, key, value) -> None:
    cache[key] = value
    while len(cache) > _CACHE_MAX:
        cache.pop(next(iter(cache)))


# ------------------------------------------------------------------ host: morton
def _spread_bits(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of x to every 3rd bit (3-D Morton interleave)."""
    u = np.uint64
    x = x.astype(np.uint64) & u(0x1FFFFF)
    x = (x | (x << u(32))) & u(0x1F00000000FFFF)
    x = (x | (x << u(16))) & u(0x1F0000FF0000FF)
    x = (x | (x << u(8))) & u(0x100F00F00F00F00F)
    x = (x | (x << u(4))) & u(0x10C30C30C30C30C3)
    x = (x | (x << u(2))) & u(0x1249249249249249)
    return x


def _morton_order(pts: np.ndarray) -> np.ndarray:
    """Sort order of (n, 3) f32 points along a 63-bit Morton curve of their
    joint-per-axis normalized grid coordinates."""
    lo = pts.min(axis=0)
    span = np.maximum(pts.max(axis=0) - lo, 1e-30)
    g = ((pts - lo) / span * (2**21 - 1)).astype(np.uint64)
    code = (
        _spread_bits(g[:, 0])
        | (_spread_bits(g[:, 1]) << np.uint64(1))
        | (_spread_bits(g[:, 2]) << np.uint64(2))
    )
    return np.argsort(code, kind="stable")


def _box_lb(plo, phi, qlo, qhi) -> np.ndarray:
    """(a, b) squared distance between AABBs: per-axis gap clamp, summed, f32
    accumulation (its rounding is orders of magnitude under the pruning margin)."""
    acc = np.zeros((plo.shape[0], qlo.shape[0]), np.float32)
    for k in range(3):
        g = np.maximum(qlo[None, :, k] - phi[:, None, k],
                       plo[:, None, k] - qhi[None, :, k]).astype(np.float32)
        np.maximum(g, 0.0, out=g)
        g *= g
        acc += g
    return acc


def _pad_tiles(pts: np.ndarray, total: int) -> np.ndarray:
    """Pad sorted points to the bucket size by repeating the last point, which keeps
    the last tile's bounding box tight; the folds mask padding by count."""
    out = np.empty((total, 3), np.float32)
    out[: len(pts)] = pts
    out[len(pts):] = pts[-1]
    return out


def _nearest_pairs(lb: np.ndarray, k_lo: int, k_hi: int) -> np.ndarray:
    """Pairs (i, j) where j is among row i's (k_lo, k_hi]-nearest columns by lb,
    or i among column j's — both directions so every tile's bounds tighten."""
    npt_v, nqt_v = lb.shape
    out = []
    if nqt_v > k_lo:
        hi = min(k_hi, nqt_v)
        jn = np.argpartition(lb, hi - 1, axis=1)[:, :hi]
        if k_lo:
            order = np.argsort(np.take_along_axis(lb, jn, axis=1), axis=1)
            jn = np.take_along_axis(jn, order, axis=1)[:, k_lo:]
        out.append(np.stack([
            np.repeat(np.arange(npt_v), jn.shape[1]), jn.reshape(-1)
        ], axis=1))
    if npt_v > k_lo:
        hi = min(k_hi, npt_v)
        im = np.argpartition(lb, hi - 1, axis=0)[:hi, :]
        if k_lo:
            order = np.argsort(np.take_along_axis(lb, im, axis=0), axis=0)
            im = np.take_along_axis(im, order, axis=0)[k_lo:, :]
        out.append(np.stack([
            im.reshape(-1), np.tile(np.arange(nqt_v), im.shape[0])
        ], axis=1))
    if not out:
        return np.empty((0, 2), np.int64)
    return np.unique(np.concatenate(out), axis=0)  # sorted by (pt, qt)


def _prepare_side(pts: np.ndarray):
    """Morton order + padded sorted points + tile AABBs + unsort rank for one cloud,
    cached by content.  Returns (key, n, b, nt_v, ps, lo, hi, rank)."""
    key = (hashlib.sha1(pts.tobytes()).hexdigest(), len(pts))
    with _LOCK:
        hit = _SIDE_CACHE.get(key)
    if hit is not None:
        return hit
    n = len(pts)
    order = _morton_order(pts)
    b = ch._bucket(n)
    ps = _pad_tiles(pts[order], b)
    nt_v = -(-n // _TP)  # tiles holding >= 1 valid point
    # the last partial tile repeats its last valid point, so its min/max are tight
    t3 = ps[: nt_v * _TP].astype(np.float64).reshape(nt_v, _TP, 3)
    lo, hi = t3.min(axis=1), t3.max(axis=1)
    rank = np.zeros(b, np.int32)
    rank[order] = np.arange(n, dtype=np.int32)  # original i -> sorted row
    out = (key, n, b, nt_v, ps, lo, hi, rank)
    with _LOCK:
        _put(_SIDE_CACHE, key, out)
    return out


class _PreparedPair(NamedTuple):
    """The host half for one (p, q) pair: each side's content key, sorted padded
    points and unsort rank, and the box lower bounds.  numpy only."""
    n: int
    m: int
    bp: int
    bq: int
    npt_v: int
    nqt_v: int
    pkey: tuple
    qkey: tuple
    ps: np.ndarray      # (bp, 3) f32, Morton order, padded
    qs: np.ndarray      # (bq, 3) f32
    rank_p: np.ndarray  # (bp,) int32: original point -> sorted row
    rank_q: np.ndarray
    lb: np.ndarray      # (npt_v, nqt_v) f32
    t_prep: float


def chamfer_prepare(p: np.ndarray, q: np.ndarray) -> Optional[_PreparedPair]:
    """The host half of the pipeline for valid points p (n, 3), q (m, 3), or None for
    an empty side.  Issues no CUDA work, so a worker thread may run it."""
    p = np.ascontiguousarray(np.asarray(p, dtype=np.float32).reshape(-1, 3))
    q = np.ascontiguousarray(np.asarray(q, dtype=np.float32).reshape(-1, 3))
    if len(p) == 0 or len(q) == 0:
        return None
    if max(len(p), len(q)) > _MAX_POINTS:
        raise ValueError(f"pruned chamfer supports up to {_MAX_POINTS} points/side")
    t0 = time.perf_counter()
    pkey, n, bp, npt_v, ps, plo, phi, rank_p = _prepare_side(p)
    qkey, m, bq, nqt_v, qs, qlo, qhi, rank_q = _prepare_side(q)
    lb = _box_lb(plo, phi, qlo, qhi)
    return _PreparedPair(n, m, bp, bq, npt_v, nqt_v, pkey, qkey, ps, qs, rank_p, rank_q,
                         lb, time.perf_counter() - t0)


def _device_side(key, ps: np.ndarray, rank: np.ndarray, n: int, device):
    """The device table (tiles, 3, 1024) f32 and unsort rank (n,) of one side, cached
    by (content, device).  The lock is held across the upload, so one table is
    uploaded once."""
    ck = (key, str(device))
    with _LOCK:
        hit = _DEVICE_CACHE.get(ck)
        if hit is None:
            tab = np.ascontiguousarray(ps.reshape(-1, _TP, 3).transpose(0, 2, 1))
            hit = (torch.from_numpy(tab).to(device),
                   torch.from_numpy(rank[:n].astype(np.int64)).to(device))
            _put(_DEVICE_CACHE, ck, hit)
    return hit


# ------------------------------------------------------------------ the fold (K11)
def chamfer_fold_pairs_plain(pairs, p_tab, q_tab, n, m, pmin, qmin):
    """Plain version of K11.  Folds every (p-tile, q-tile) pair of ``pairs`` (K, 2)
    int into the running minima ``pmin`` (p tiles * 1024,) and ``qmin`` (q tiles *
    1024,) f32, in place: the (1024 x 1024) block of distances between the two
    tiles of ``p_tab`` / ``q_tab`` (tiles, 3, 1024), its points valid below the counts
    ``n`` / ``m`` (in sorted order; padding is masked by count).  Returns (pmin,
    qmin)."""
    T = _TP
    rows = torch.arange(T, device=pmin.device)
    inf = torch.tensor(float("inf"), device=pmin.device)
    for lo in range(0, pairs.shape[0], _PLAIN_PAIRS_PER_STEP):
        pt = pairs[lo:lo + _PLAIN_PAIRS_PER_STEP, 0].long()
        qt = pairs[lo:lo + _PLAIN_PAIRS_PER_STEP, 1].long()
        P, Q = p_tab[pt], q_tab[qt]  # (k, 3, T)
        d = ch.sq_dists(P[:, 0, :, None], P[:, 1, :, None], P[:, 2, :, None],
                        Q[:, 0, None, :], Q[:, 1, None, :], Q[:, 2, None, :])  # (k, T, T)
        pidx = pt[:, None] * T + rows  # (k, T) sorted rows
        qidx = qt[:, None] * T + rows
        pv, qv = pidx < n, qidx < m
        rowmin = torch.where(qv[:, None, :], d, inf).amin(2)
        colmin = torch.where(pv[:, :, None], d, inf).amin(1)
        pmin.scatter_reduce_(0, pidx.reshape(-1),
                             torch.where(pv, rowmin, inf).clamp_min(0.0).reshape(-1), "amin")
        qmin.scatter_reduce_(0, qidx.reshape(-1),
                             torch.where(qv, colmin, inf).clamp_min(0.0).reshape(-1), "amin")
    return pmin, qmin


def chamfer_fold_pairs(pairs, p_tab, q_tab, n, m, pmin, qmin, *, impl="auto"):
    """K11 wrapper; operands and results as ``chamfer_fold_pairs_plain``.  The minima
    merge by an integer atomicMin on the bits of the non-negative f32 distances:
    exact, and the same on every run."""
    if not use_kernel(pmin, impl):
        return chamfer_fold_pairs_plain(pairs, p_tab, q_tab, n, m, pmin, qmin)
    what = "chamfer_fold_pairs"
    dev = pmin.device
    if (pairs.dtype != torch.int32 or pairs.ndim != 2 or pairs.shape[1] != 2
            or not pairs.is_contiguous()):
        raise ValueError(f"{what}: pairs must be contiguous (K, 2) int32")
    for name, tab, mins, count in (("p", p_tab, pmin, n), ("q", q_tab, qmin, m)):
        if (tab.dtype != torch.float32 or tab.ndim != 3 or tuple(tab.shape[1:]) != (3, _TP)
                or not tab.is_contiguous()):
            raise ValueError(f"{what}: the {name} table must be contiguous (tiles, 3, {_TP}) "
                             f"float32")
        if (mins.dtype != torch.float32 or tuple(mins.shape) != (tab.shape[0] * _TP,)
                or not mins.is_contiguous()):
            raise ValueError(f"{what}: the {name} minima must be contiguous f32 of one "
                             f"entry per table row")
        if not 0 <= count <= tab.shape[0] * _TP:
            raise ValueError(f"{what}: {name} count {count} out of range")
    if not all(t.device == dev for t in (pairs, p_tab, q_tab, qmin)):
        raise ValueError(f"{what}: every operand must be on {dev}")
    K = pairs.shape[0]
    if K:
        code = _build.lib().hs_chamfer_fold_pairs(pairs.data_ptr(), K, p_tab.data_ptr(),
                                                  q_tab.data_ptr(), pmin.data_ptr(),
                                                  qmin.data_ptr(), n, m, stream(pmin))
        check(code, what)
        launches[what] += 1
        launches_by_shape[(what, K)] += 1
    return pmin, qmin


def _tile_bounds(mins, count: int, nt_v: int) -> np.ndarray:
    """Per tile, the largest running minimum of its valid points (f64 on the host)."""
    v = mins[: nt_v * _TP].reshape(nt_v, _TP)
    valid = torch.arange(nt_v * _TP, device=mins.device).reshape(nt_v, _TP) < count
    return torch.where(valid, v, -torch.inf).amax(1).cpu().numpy().astype(np.float64)


def _point_pairs(pairs: np.ndarray, n: int, m: int) -> int:
    """The point pairs the tile pairs hold: valid p points x valid q points, summed."""
    vp = np.clip(n - pairs[:, 0].astype(np.int64) * _TP, 0, _TP)
    vq = np.clip(m - pairs[:, 1].astype(np.int64) * _TQ, 0, _TQ)
    return int(np.sum(vp * vq))


def chamfer_distance_pruned(p: np.ndarray, q: np.ndarray, *, impl="auto", device=None,
                            stats: dict | None = None,
                            prepared: Optional[_PreparedPair] = None) -> float:
    """Exact Chamfer distance by neighbour-pruned enumeration.  p (n, 3), q (m, 3)
    float arrays of valid points.  ``prepared``: a ``chamfer_prepare(p, q)`` result
    made elsewhere (e.g. in a worker thread).  ``stats`` receives the route, n, m,
    the pairs of every tightening round and of the final sweep (``round_pairs``,
    ``final_pairs``, the lists in ``folds``), ``dense_pairs``, ``work_frac`` (folded
    tile pairs x 1024^2 over n*m, as the JAX package counts it), ``folded_point_pairs``
    (the valid point pairs of the folded tiles), the per-point minima ``d_pq`` /
    ``d_qp`` in the original order, and the host times ``t_prep``, ``t_rounds``,
    ``t_final``."""
    device = default_device(device)
    pr = prepared if prepared is not None else chamfer_prepare(p, q)
    if pr is None:
        return float("nan")
    n, m, npt_v, nqt_v, lb = pr.n, pr.m, pr.npt_v, pr.nqt_v, pr.lb
    t0 = time.perf_counter()
    p_tab, rank_p = _device_side(pr.pkey, pr.ps, pr.rank_p, n, device)
    q_tab, rank_q = _device_side(pr.qkey, pr.qs, pr.rank_q, m, device)
    pmin = torch.full((pr.bp,), float("inf"), dtype=torch.float32, device=device)
    qmin = torch.full((pr.bq,), float("inf"), dtype=torch.float32, device=device)
    folds = []

    def fold(pairs):
        folds.append(pairs)
        if len(pairs):
            pd = torch.from_numpy(np.ascontiguousarray(pairs, dtype=np.int32)).to(device)
            chamfer_fold_pairs(pd, p_tab, q_tab, n, m, pmin, qmin, impl=impl)

    # tightening rounds: nearest tiles first, bounds fetched after each
    done = np.zeros((npt_v, nqt_v), bool)
    ubp = ubq = None
    k_lo = 0
    for k_hi in _ROUNDS:
        pairs = _nearest_pairs(lb, k_lo, k_hi)
        if k_lo and ubp is not None:
            sel = (lb[pairs[:, 0], pairs[:, 1]]
                   < np.maximum(ubp[pairs[:, 0]], ubq[pairs[:, 1]]) * _MARGIN)
            sel &= ~done[pairs[:, 0], pairs[:, 1]]
            pairs = pairs[sel]
        done[pairs[:, 0], pairs[:, 1]] = True
        fold(pairs)
        ubp = _tile_bounds(pmin, n, npt_v)
        ubq = _tile_bounds(qmin, m, nqt_v)
        k_lo = k_hi

    # the final survivors: pairs whose lower bound could still beat some covered
    # point's current minimum, in either direction
    keep = (lb < ubp[:, None] * _MARGIN) | (lb < ubq[None, :] * _MARGIN)
    keep &= ~done
    t_rounds = time.perf_counter() - t0
    fold(np.argwhere(keep).astype(np.int32))  # row-major: sorted by p-tile

    d_pq, d_qp = pmin[rank_p], qmin[rank_q]
    val = float(ch._means(d_pq, d_qp))
    if stats is not None:
        tile_pairs = sum(len(f) for f in folds)
        stats.update(route="pruned", n=n, m=m, round_pairs=[len(f) for f in folds[:-1]],
                     final_pairs=len(folds[-1]), dense_pairs=npt_v * nqt_v, folds=folds,
                     work_frac=tile_pairs * _TP * _TQ / (n * m),
                     folded_point_pairs=sum(_point_pairs(f, n, m) for f in folds),
                     d_pq=d_pq.cpu().numpy(), d_qp=d_qp.cpu().numpy(), t_prep=pr.t_prep,
                     t_rounds=t_rounds, t_final=time.perf_counter() - t0 - t_rounds)
    return val
