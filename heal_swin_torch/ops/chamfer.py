"""Chamfer distance: the brute fold (K10) and the host API (counterpart of
``heal_swin_tpu/ops/chamfer.py``).

chamfer(p, q) = mean_i min_j |p_i - q_j|^2 + mean_j min_i |q_j - p_i|^2 over the valid
points: the semantics of the reference's CUDA chamfer module (custom_metrics.py:
569-573), mean of squared nearest-neighbour distances in both directions.

The per-pair distance is the difference form in f32, rounded after every operation:
d = (dx*dx + dy*dy) + dz*dz with dx = px - qx and so on (the Pallas kernels',
``chamfer.py:143-146`` and ``chamfer_pruned.py:182-185``).  K10, K11 and their plain
versions all compute it so; a min is exact and takes no order, so their per-point
minima are bit-equal, and pruning pairs whose distance cannot win changes no bit.

``chamfer_distance`` sends a pair to the neighbour-pruned pipeline
(``ops/chamfer_pruned.py``, K11) when n*m >= ``_PRUNE_MIN_PAIRS`` and to the brute
fold (K10) below, or where its ``route`` argument says (the counterpart of the JAX
package's ``HEAL_SWIN_CHAMFER_IMPL`` variable; nothing here reads the environment).
Both routes reduce the minima with ``_means`` on the device, so a pair gives the same
scalar bits on either.  ``impl`` picks kernel or plain version as everywhere in the
port (``ops/_dispatch.py``); the entry points run on the first CUDA device unless
given ``device``.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from heal_swin_torch import _build
from heal_swin_torch.ops._dispatch import check, default_device, stream, use_kernel

# The JAX package's threshold (its brute kernel beat the pruned pipeline's host work
# below it on the TPU); the port keeps it until the card's own times set it.
_PRUNE_MIN_PAIRS = 2.5e11
# the plain version's (rows x M) f32 distance block: 64 MiB
_PLAIN_BLOCK_ELEMS = 1 << 24

# launch counters, bumped only where the kernel launches: per kernel, and per
# (kernel, N, M)
launches = {"chamfer_min_both": 0}
launches_by_shape: Counter = Counter()


def sq_dists(px, py, pz, qx, qy, qz):
    """Squared distances between broadcast coordinates, f32, the kernels' expression
    and rounding points: (dx*dx + dy*dy) + dz*dz, one rounding per operation."""
    d = px - qx
    d.mul_(d)
    t = py - qy
    d.add_(t.mul_(t))
    t = pz - qz
    return d.add_(t.mul_(t))


def chamfer_min_both_plain(p, q, n=None, m=None):
    """Plain version of K10.  p (N, 3), q (M, 3) f32; the first ``n`` rows of p and
    ``m`` of q are valid (all when None).  Returns pmin (N,): min over valid q of d,
    and qmin (M,): min over valid p; inf at invalid rows.  Chunked over p, so memory
    stays O(chunk * M)."""
    N, M = p.shape[0], q.shape[0]
    n = N if n is None else n
    m = M if m is None else m
    pmin = torch.full((N,), float("inf"), dtype=torch.float32, device=p.device)
    qmin = torch.full((M,), float("inf"), dtype=torch.float32, device=p.device)
    if n == 0 or m == 0:
        return pmin, qmin
    qx, qy, qz = (q[:m, c].float().contiguous()[None, :] for c in range(3))
    chunk = max(1, _PLAIN_BLOCK_ELEMS // m)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        px, py, pz = (p[lo:hi, c].float()[:, None] for c in range(3))
        d = sq_dists(px, py, pz, qx, qy, qz)
        pmin[lo:hi] = d.amin(1)
        torch.minimum(qmin[:m], d.amin(0), out=qmin[:m])
    return pmin.clamp_min_(0.0), qmin.clamp_min_(0.0)


def _points(what, t):
    if t.dtype != torch.float32 or t.ndim != 2 or t.shape[1] != 3:
        raise ValueError(f"{what}: points must be (N, 3) float32, got {tuple(t.shape)} "
                         f"{t.dtype}")
    return t.contiguous()


def chamfer_min_both(p, q, n=None, m=None, *, impl="auto"):
    """K10 wrapper: both nearest-neighbour minima of p against q; operands and
    results as ``chamfer_min_both_plain``.  Inputs must be finite (the writers filter
    their clouds so)."""
    if not use_kernel(p, impl):
        return chamfer_min_both_plain(p, q, n, m)
    what = "chamfer_min_both"
    p, q = _points(what, p), _points(what, q)
    if q.device != p.device:
        raise ValueError(f"{what}: p and q must be on one device")
    N, M = p.shape[0], q.shape[0]
    n = N if n is None else n
    m = M if m is None else m
    if not (0 <= n <= N and 0 <= m <= M):
        raise ValueError(f"{what}: valid counts n={n}, m={m} out of range for {N}, {M}")
    pmin = torch.full((N,), float("inf"), dtype=torch.float32, device=p.device)
    qmin = torch.full((M,), float("inf"), dtype=torch.float32, device=p.device)
    if n and m:
        code = _build.lib().hs_chamfer_min_both(p.data_ptr(), q.data_ptr(), pmin.data_ptr(),
                                                qmin.data_ptr(), n, m, stream(p))
        check(code, what)
        launches[what] += 1
        launches_by_shape[(what, N, M)] += 1
    return pmin, qmin


def _means(d_pq, d_qp):
    """mean(d_pq) + mean(d_qp) as one f32 scalar tensor: the minima of the valid
    points, in any order, clamped at 0 (the JAX package's masked means)."""
    n, m = max(d_pq.shape[0], 1), max(d_qp.shape[0], 1)
    return d_pq.clamp_min(0.0).sum() / n + d_qp.clamp_min(0.0).sum() / m


def _bucket(n: int) -> int:
    """Half-octave bucket (2048 * {1, 1.5} * 2^k) >= n: the padded size of a cloud's
    sorted tile table in the pruned pipeline (a multiple of its 1024-point tile)."""
    b = 2048
    while True:
        if n <= b:
            return b
        if n <= b + b // 2:
            return b + b // 2
        b *= 2


def _impl(n: int, m: int, route=None) -> str:
    """The route of an (n, m) pair: ``route`` when given ("pruned" | "brute"), else
    pruned from ``_PRUNE_MIN_PAIRS`` pairs on."""
    if route is not None:
        if route not in ("pruned", "brute"):
            raise ValueError(f"unknown route {route!r}: expected 'pruned' or 'brute'")
        return route
    return "pruned" if float(n) * float(m) >= _PRUNE_MIN_PAIRS else "brute"


def _as_points(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32).reshape(-1, 3))


def prepare_pair(p, q, route=None):
    """The host half of the pruned route for (p, q) (Morton sort, tile tables, box
    bounds; numpy only, so a worker thread may run it while the device folds another
    pair), or None when the pair takes the brute route or a side is empty.  Pass the
    result to ``chamfer_distance`` as ``prepared``."""
    p, q = _as_points(p), _as_points(q)
    if len(p) == 0 or len(q) == 0 or _impl(len(p), len(q), route) != "pruned":
        return None
    from heal_swin_torch.ops.chamfer_pruned import chamfer_prepare

    return chamfer_prepare(p, q)


def chamfer_distance(p, q, prepared=None, *, route=None, impl="auto", device=None,
                     stats=None) -> float:
    """Host API: p (N, 3), q (M, 3) float arrays of valid points (ragged sizes fine)
    -> the Chamfer distance, NaN when a side is empty.  ``prepared``: an optional
    ``prepare_pair(p, q)`` result; ``route``: "pruned" | "brute" | None (the n*m
    rule); ``stats``: a dict that receives the route, n, m and the per-point minima
    ``d_pq`` / ``d_qp`` in the original point order (and the pruned pipeline's
    statistics)."""
    device = default_device(device)
    p, q = _as_points(p), _as_points(q)
    if len(p) == 0 or len(q) == 0:
        return float("nan")
    if _impl(len(p), len(q), route) == "pruned":
        from heal_swin_torch.ops.chamfer_pruned import chamfer_distance_pruned

        return chamfer_distance_pruned(p, q, prepared=prepared, impl=impl, device=device,
                                       stats=stats)
    pmin, qmin = chamfer_min_both(torch.from_numpy(p).to(device),
                                  torch.from_numpy(q).to(device), impl=impl)
    val = float(_means(pmin, qmin))
    if stats is not None:
        stats.update(route="brute", n=len(p), m=len(q), d_pq=pmin.cpu().numpy(),
                     d_qp=qmin.cpu().numpy())
    return val
