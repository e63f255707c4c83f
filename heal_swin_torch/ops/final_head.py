"""Decoder tail: FinalPatchExpand -> LayerNorm -> head, fused with the argmax (K3,
serving), with the weighted cross entropy and the confusion matrix (K6 forward, K7
backward, segmentation training), or with the masked depth loss (K8 forward, K9
backward, depth training).

Counterpart of ``fused_final_head_predict``, ``fused_final_head`` and
``fused_final_head_depth`` in ``heal_swin_tpu/ops/final_head.py``.  The p sub-rows of
the expand reshape (T, p*C) -> (T*p, C) are the p column slices of the expand output,
so the tail is p independent (C, C) products per token.  Per sub-row: h = x @ We_i
(f32 accumulation, rounded to x's dtype) -> LayerNorm with f32 statistics -> z in x's
dtype -> logits z @ Wh in f32.

- Predict (K3): the f32 logits, not rounded -> argmax with the lowest index on ties;
  a row holding a NaN gives F - 1.  Returns (T, p) int32.  On the card it runs on the
  persistent blocks of K6-K9 below, and its logits come from the same functions as
  theirs: rounded to x's dtype they are K6's (a tap returns them).
- Loss (K6/K7): the logits rounded to x's dtype -> log-softmax -> weighted NLL.
  Returns loss = sum w*nll / max(sum w, 1e-12) and the (F, F) f32 confusion matrix
  (target rows, argmax columns, lowest index on ties) over every element; a row
  holding a NaN counts in no cell.  The backward scales dlogits = w * (softmax -
  onehot) by gloss / max(sum w, 1e-12), rounds it, and rounds the LayerNorm
  backward's dh before the expand products.  On the card both run on persistent
  blocks that walk 128-row tiles (block b: tiles b, b + grid, ...) and write one
  partial row each; K7 is a launch sequence from one entry: its row kernel (dx, the
  rounded dh of every sub-pixel, partial rows [dWh | dgamma | dbeta]), dWe = x^T dh,
  and the reduction of the partial rows.  Each step has a plain twin here
  (``final_head_loss_bwd_rows_plain``, ``final_head_loss_dwe_plain``,
  ``reduce_rows_plain``; composed: ``final_head_loss_bwd_sequence_plain``), and so
  do K6's partial rows (``final_head_loss_partials_plain``).
- Depth loss (K8/K9): F in {1, 2} output channels (mean, logvar); targets (T, p) f32
  with a non-finite value marking background.  The loss of kind l2 / l1 / huber /
  nll takes the f32 logits (not rounded; only the emitted predictions are rounded to
  x's dtype) and selects an invalid target to 0 before the subtraction, so it never
  enters the arithmetic.  Returns loss = sum loss / max(count, 1) and the (T, p*F)
  predictions.  The backward's dlogits = (gloss / max(count, 1)) * dloss/dlogits
  stay f32; dh is rounded before the expand products.  On the card K8 and K9 run on
  K6's and K7's persistent blocks, and K9 is a launch sequence like K7's: its row
  kernel, dWe = x^T dh, the reduction of the partial rows.  Twins:
  ``final_head_depth_loss_partials_plain``, ``final_head_depth_loss_bwd_rows_plain``
  with ``final_head_loss_dwe_plain`` and ``reduce_rows_plain`` (composed:
  ``final_head_depth_loss_bwd_sequence_plain``).

- Float32 (K3, K6-K9): x f32 runs their f32 kernels (``csrc/tail_f32.cuh``; entries in
  ``final_head_f32.cu`` and ``final_head_depth_f32.cu``), nothing rounded below f32, as
  the Pallas kernels compute with f32 operands, every product on the tensor cores in
  3xTF32.  On the card a block of 8 warps holds one expand slice and walks the
  sub-pixels in an outer loop, each over the same 128-row tiles (block b: tiles b, b +
  grid, ...), a warp 16 rows; K3, K6 and K8 are one tile kernel with the argmax, the
  cross entropy or the depth loss on its logits (K8's predictions are its f32 logits).
  K7 and K9 are their tile kernel (dx and one partial row a block: dWe = x^T dh over the
  block's rows, dWh, dgamma, dbeta; dh never leaves the chip) and ``reduce_rows``.  Their
  twins: ``final_head_loss_bwd_rows_f32_plain`` and
  ``final_head_depth_loss_bwd_rows_f32_plain`` with ``reduce_rows_plain`` (composed:
  ``final_head_loss_bwd_sequence_f32_plain``,
  ``final_head_depth_loss_bwd_sequence_f32_plain``).

Every wrapper dispatches on ``impl`` like the attention wrappers
(``heal_swin_torch.ops._dispatch.use_kernel``): on a CUDA tensor it runs its kernel or
raises, and a tail the kernel was not written for (a dtype it lacks, the shapes of
``kernels_take`` / ``depth_kernels_take``, the shared-memory limit) raises under "auto"
as under "pallas", naming the kernel that refuses and "xla" as the plain route; a loss's
backward takes the same route as its forward.
"""

from __future__ import annotations

from collections import Counter

import torch

from heal_swin_torch import _build
from heal_swin_torch.ops._dispatch import check, f32_suffix, refuse, stream, use_kernel

LN_EPS = 1e-5
KERNEL_ROWS = 64  # T a multiple of it for all five (gemm_tn's token steps in K7, K9)
TAIL_TILE_ROWS = 128  # token rows of a block tile: 8 warps of 16 rows
KERNEL_MAX_F = 32  # the class head's widest instantiation: four head n-tiles
KERNEL_MAX_F_F32 = 16  # the f32 K3/K6/K7's widest head: 16 columns
KERNEL_SMEM_LIMIT = 232448  # bytes a block may opt in to on sm_90
KERNEL_MAX_C_LOSS_BWD = 128  # the row core's widest instantiation
# the row core holds a row's C columns in mma accumulators, one instantiation per C
KERNEL_LOSS_CS = (32, 64, 96, 128)
DEPTH_KINDS = ("l2", "l1", "huber", "nll")  # K8/K9's loss kinds, in their launch ids
# the tail kernels by the library's names of their shared-memory figures; each has an
# f32 variant ("predict_f32", "loss_f32", ..., "depth_loss_bwd_f32")
KERNEL_IDS = {"predict": "K3", "loss": "K6", "loss_bwd": "K7", "depth_loss": "K8",
              "depth_loss_bwd": "K9"}
F32_KERNELS = ("predict", "loss", "loss_bwd", "depth_loss", "depth_loss_bwd")

# launch counters, bumped only where a kernel launches: per kernel, and per
# (kernel, T, C), or (kernel, T, C, F, kind) for K8/K9
launches = {"final_head_predict": 0, "final_head_loss": 0, "final_head_loss_bwd": 0,
            "final_head_depth_loss": 0, "final_head_depth_loss_bwd": 0,
            "final_head_predict_f32": 0, "final_head_loss_f32": 0, "final_head_loss_bwd_f32": 0,
            "final_head_depth_loss_f32": 0, "final_head_depth_loss_bwd_f32": 0}
launches_by_shape: Counter = Counter()


def _count(what, *shape):
    launches[what] += 1
    launches_by_shape[(what,) + shape] += 1


def argmax_lowest(lf: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis, lowest index on ties, F - 1 for any row with a NaN
    (the max is NaN there, no lane compares >= it, and the index clamps)."""
    F = lf.shape[-1]
    mx = lf.amax(-1, keepdim=True)
    lane = torch.arange(F, device=lf.device)
    idx = torch.where(lf >= mx, lane, torch.full_like(lane, F)).amin(-1)
    return torch.clamp_max(idx, F - 1).to(torch.int32)


def _split_we(we, dt, patch_size):
    """(C, p*C) JAX-layout expand weight -> (p, C, C) in ``dt``: slice i is the expand
    of sub-pixel i."""
    C = we.shape[0]
    return we.to(dt).reshape(C, patch_size, C).permute(1, 0, 2)


def _ln_rows(hf, gamma, beta):
    """f32 LayerNorm over the last axis: (y, xhat, rstd)."""
    mean = hf.mean(-1, keepdim=True)
    xc = hf - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + LN_EPS)
    xhat = xc * rstd
    return xhat * gamma.float() + beta.float(), xhat, rstd


def _sub_rows(x, we_s, gamma, beta, i):
    """Sub-pixel i of every token: (z f32 of the rounded LN output, xhat, rstd)."""
    dt = x.dtype
    h = (x.float() @ we_s[i].float()).to(dt).float()
    z, xhat, rstd = _ln_rows(h, gamma, beta)
    return z.to(dt).float(), xhat, rstd


def final_head_logits_plain(x, we, gamma, beta, wh, *, patch_size):
    """x: (T, C); we: (C, p*C) (JAX layout); gamma/beta: (C,); wh: (C, F) ->
    (T, p, F) float32 logits, rounded like the kernel up to the head product."""
    we_s = _split_we(we, x.dtype, patch_size)
    whf = wh.to(x.dtype).float()
    return torch.stack([_sub_rows(x, we_s, gamma, beta, i)[0] @ whf
                        for i in range(patch_size)], dim=1)


def final_head_predict_plain(x, we, gamma, beta, wh, *, patch_size):
    """Plain version of K3: (T, p) int32 class indices."""
    return argmax_lowest(final_head_logits_plain(x, we, gamma, beta, wh,
                                                 patch_size=patch_size))


def _ce_rows(lf, yi):
    """Cross entropy on (rows, F) f32 logits and (rows,) targets: (softmax, onehot,
    nll, argmax index with F for a row holding a NaN), as ``_slice_ce``."""
    F = lf.shape[-1]
    mx = lf.amax(-1, keepdim=True)  # NaN where the row holds one
    e = torch.exp(lf - mx)
    se = e.sum(-1, keepdim=True)
    lane = torch.arange(F, device=lf.device)
    onehot = (lane == yi[:, None]).float()
    nll = mx[:, 0] + torch.log(se[:, 0]) - (lf * onehot).sum(-1)
    pred = torch.where(lf >= mx, lane, torch.full_like(lane, F)).amin(-1)
    return e / se, onehot, nll, pred


def _ce_slices(x, we, gamma, beta, wh, y, welem, *, patch_size):
    """K6's cross entropy, sub-pixel by sub-pixel: yields (targets, weights, nll, argmax
    with F for a row holding a NaN, whether the element counts in the confusion
    matrix), each (T,), of the logits rounded to x's dtype."""
    F = wh.shape[-1]
    we_s = _split_we(we, x.dtype, patch_size)
    whf = wh.to(x.dtype).float()
    for i in range(patch_size):
        z, _, _ = _sub_rows(x, we_s, gamma, beta, i)
        yi = y[:, i].long()
        _, _, nll, pred = _ce_rows((z @ whf).to(x.dtype).float(), yi)
        yield yi, welem[:, i].float(), nll, pred, (pred < F) & (yi >= 0) & (yi < F)


def final_head_loss_plain(x, we, gamma, beta, wh, y, welem, *, patch_size):
    """Plain version of K6.  y: (T, p) int targets; welem: (T, p) f32 per-element
    weights.  Returns (sum w*nll, sum w, confusion matrix (F, F)), all f32."""
    F = wh.shape[-1]
    num = torch.zeros((), dtype=torch.float32, device=x.device)
    den = torch.zeros((), dtype=torch.float32, device=x.device)
    cm = torch.zeros(F * F, dtype=torch.float32, device=x.device)
    for yi, wi, nll, pred, counted in _ce_slices(x, we, gamma, beta, wh, y, welem,
                                                 patch_size=patch_size):
        num = num + (wi * nll).sum()
        den = den + wi.sum()
        cm = cm + torch.bincount((yi * F + pred)[counted], minlength=F * F).float()
    return num, den, cm.reshape(F, F)


def _tail_bwd_slices(x, we, gamma, beta, wh, dlogits_of, *, patch_size):
    """The backward of the tail, sub-pixel by sub-pixel, from the dlogits of each:
    ``dlogits_of(i, z, whf)`` -> (T, F) f32 dlogits of sub-pixel i from its (T, C) z
    and the f32 head (C, F).  Yields (z, dlogits, dz = dlogits Wh^T, xhat, dh, We_i):
    dh the LayerNorm backward's, rounded to x's dtype (as f32), We_i in x's dtype."""
    dt = x.dtype
    we_s = _split_we(we, dt, patch_size)
    whf = wh.to(dt).float()
    g = gamma.float()
    for i in range(patch_size):
        z, xhat, rstd = _sub_rows(x, we_s, gamma, beta, i)
        dlog = dlogits_of(i, z, whf)
        dz = dlog @ whf.t()
        dzh = dz * g
        dh = rstd * (dzh - dzh.mean(-1, keepdim=True)
                     - xhat * (dzh * xhat).mean(-1, keepdim=True))
        yield z, dlog, dz, xhat, dh.to(dt).float(), we_s[i]


def _tail_bwd_plain(x, we, gamma, beta, wh, dlogits_of, *, patch_size):
    """The backward of the tail (``_tail_bwd_slices``): dWh += z^T dlogits, dgamma,
    dbeta, dx = sum_i dh_i We_i^T, dWe_i = x^T dh_i.  Returns (dx (T, C) in x's dtype,
    dwe (C, p*C), dgamma (C,), dbeta (C,), dwh (C, F)), the last four f32."""
    T, C = x.shape
    F = wh.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.zeros((T, C), **f32)
    dwh = torch.zeros((C, F), **f32)
    dg = torch.zeros(C, **f32)
    db = torch.zeros_like(dg)
    dwe = []
    for z, dlog, dz, xhat, dh, we_i in _tail_bwd_slices(x, we, gamma, beta, wh, dlogits_of,
                                                         patch_size=patch_size):
        dwh = dwh + z.t() @ dlog
        dg = dg + (dz * xhat).sum(0)
        db = db + dz.sum(0)
        dx = dx + dh @ we_i.float().t()
        dwe.append(x.float().t() @ dh)
    return dx.to(x.dtype), torch.cat(dwe, dim=1), dg, db, dwh


def _ce_dlogits(y, welem, scale, dt):
    """K7's dlogits of sub-pixel i: scale w (softmax - onehot) of the logits rounded to
    ``dt``, itself rounded to ``dt``; a ``dlogits_of`` of ``_tail_bwd_slices``."""

    def dlogits_of(i, z, whf):
        lf = (z @ whf).to(dt).float()
        sm, onehot, _, _ = _ce_rows(lf, y[:, i].long())
        return ((scale * welem[:, i].float())[:, None] * (sm - onehot)).to(dt).float()

    return dlogits_of


def final_head_loss_bwd_plain(x, we, gamma, beta, wh, y, welem, scale, *, patch_size):
    """Plain version of K7, the backward of K6 for loss gradient ``gloss``:
    scale = gloss / max(sum w, 1e-12) (a 0-d f32 tensor).  Results as
    ``_tail_bwd_plain``."""
    return _tail_bwd_plain(x, we, gamma, beta, wh, _ce_dlogits(y, welem, scale, x.dtype),
                           patch_size=patch_size)


def _row_blocks(T, grid, device):
    """The block of each token row: block b walks the 128-row tiles b, b + grid, ..."""
    return (torch.arange(T, device=device) // TAIL_TILE_ROWS) % grid


def _block_sums(v, grid):
    """(T, ...) per-row terms -> (grid, ...) each block's sum over its tiles' rows."""
    out = torch.zeros((grid,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
    return out.index_add_(0, _row_blocks(v.shape[0], grid, v.device), v)


def _block_products(a, b, grid):
    """(grid, A, B): each block's a^T b over its tiles' rows; a (T, A), b (T, B)."""
    pad = -a.shape[0] % TAIL_TILE_ROWS
    at = torch.nn.functional.pad(a, (0, 0, 0, pad)).reshape(-1, TAIL_TILE_ROWS, a.shape[1])
    bt = torch.nn.functional.pad(b, (0, 0, 0, pad)).reshape(-1, TAIL_TILE_ROWS, b.shape[1])
    per_tile = at.transpose(1, 2) @ bt
    out = torch.zeros((grid,) + tuple(per_tile.shape[1:]), dtype=a.dtype, device=a.device)
    return out.index_add_(0, torch.arange(per_tile.shape[0], device=a.device) % grid, per_tile)


def final_head_loss_partials_plain(x, we, gamma, beta, wh, y, welem, *, patch_size, grid):
    """Plain twin of K6's partial rows on ``grid`` persistent blocks, block b walking
    the 128-row tiles b, b + grid, ...: (grid, 2 + F*F) f32, each row [sum w*nll,
    sum w, confusion matrix (F x F) flattened] over the block's rows; their sum over
    the blocks is ``final_head_loss_plain``."""
    T = x.shape[0]
    F = wh.shape[-1]
    num = torch.zeros(T, dtype=torch.float32, device=x.device)
    den = torch.zeros_like(num)
    blk = _row_blocks(T, grid, x.device)
    cm = torch.zeros(grid * F * F, dtype=torch.float32, device=x.device)
    for yi, wi, nll, pred, counted in _ce_slices(x, we, gamma, beta, wh, y, welem,
                                                 patch_size=patch_size):
        num = num + wi * nll
        den = den + wi
        cell = (blk * F + yi) * F + pred
        cm = cm + torch.bincount(cell[counted], minlength=grid * F * F).float()
    return torch.cat([_block_sums(num, grid)[:, None], _block_sums(den, grid)[:, None],
                      cm.reshape(grid, F * F)], dim=1)


def _bwd_rows_plain(x, we, gamma, beta, wh, dlogits_of, *, patch_size, grid):
    """The row step of a backward launch sequence on ``grid`` persistent blocks, from
    the dlogits of each sub-pixel (``_tail_bwd_slices``): (dx, dh, partial rows) as
    ``final_head_loss_bwd_rows_plain``."""
    T, C = x.shape
    F = wh.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.zeros((T, C), **f32)
    dwh = torch.zeros((grid, C, F), **f32)
    dg = torch.zeros((grid, C), **f32)
    db = torch.zeros_like(dg)
    dhs = []
    for z, dlog, dz, xhat, dh, we_i in _tail_bwd_slices(x, we, gamma, beta, wh, dlogits_of,
                                                         patch_size=patch_size):
        dwh = dwh + _block_products(z, dlog, grid)
        dg = dg + _block_sums(dz * xhat, grid)
        db = db + _block_sums(dz, grid)
        dx = dx + dh @ we_i.float().t()
        dhs.append(dh)
    part = torch.cat([dwh.reshape(grid, C * F), dg, db], dim=1)
    return dx.to(x.dtype), torch.cat(dhs, dim=1).to(x.dtype), part


def _bwd_steps_composed(x, wh, rows):
    """The dWe and reduction steps on the row step's (dx, dh, partial rows): (dx, dwe,
    dgamma, dbeta, dwh) as ``_tail_bwd_plain``."""
    C, F = wh.shape
    dx, dh, part = rows
    dwh, dg, db = reduce_rows_plain(part).split([C * F, C, C])
    return dx, final_head_loss_dwe_plain(x, dh), dg, db, dwh.reshape(C, F)


def final_head_loss_bwd_rows_plain(x, we, gamma, beta, wh, y, welem, scale, *, patch_size,
                                   grid):
    """Plain twin of the first step of the bf16 K7's launch sequence, its row kernel on
    ``grid`` persistent blocks (tiles as ``final_head_loss_partials_plain``): (dx (T, C) in x's
    dtype, dh (T, p*C) in x's dtype (sub-pixel i's rounded dh in columns i*C ..), the
    partial rows (grid, C*F + 2*C) f32, [dWh (C x F) | dgamma | dbeta] over each
    block's rows)."""
    return _bwd_rows_plain(x, we, gamma, beta, wh, _ce_dlogits(y, welem, scale, x.dtype),
                           patch_size=patch_size, grid=grid)


def final_head_loss_dwe_plain(x, dh):
    """Plain twin of the dWe step of the bf16 K7 and K9: dWe = x^T dh, (C, p*C) f32 from
    x (T, C) and the row step's dh (T, p*C)."""
    return x.float().t() @ dh.float()


def reduce_rows_plain(part):
    """Plain twin of the reduction step: the sum of the partial rows over the blocks."""
    return part.sum(0)


def final_head_loss_bwd_sequence_plain(x, we, gamma, beta, wh, y, welem, scale, *,
                                       patch_size, grid):
    """K7's three steps' twins composed: results as ``final_head_loss_bwd_plain``."""
    return _bwd_steps_composed(x, wh, final_head_loss_bwd_rows_plain(
        x, we, gamma, beta, wh, y, welem, scale, patch_size=patch_size, grid=grid))


def _bwd_rows_f32_plain(x, we, gamma, beta, wh, dlogits_of, *, patch_size, grid):
    """The f32 tile step of a backward on ``grid`` persistent blocks, from the dlogits of
    each sub-pixel (``_tail_bwd_slices``, in f32): (dx, partial rows) as
    ``final_head_loss_bwd_rows_f32_plain``."""
    T, C = x.shape
    F = wh.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.zeros((T, C), **f32)
    dwh = torch.zeros((grid, C, F), **f32)
    dg = torch.zeros((grid, C), **f32)
    db = torch.zeros_like(dg)
    dwe = []
    for z, dlog, dz, xhat, dh, we_i in _tail_bwd_slices(x, we, gamma, beta, wh, dlogits_of,
                                                         patch_size=patch_size):
        dwh = dwh + _block_products(z, dlog, grid)
        dg = dg + _block_sums(dz * xhat, grid)
        db = db + _block_sums(dz, grid)
        dx = dx + dh @ we_i.float().t()
        dwe.append(_block_products(x.float(), dh, grid))
    return dx, torch.cat([torch.cat(dwe, dim=2).reshape(grid, -1), dwh.reshape(grid, C * F),
                          dg, db], dim=1)


def split_f32_bwd_row(red, C, F, patch_size):
    """The f32 K7's and K9's reduced partial row [dWe (C x p*C) | dWh (C x F) | dgamma |
    dbeta] -> (dwe, dgamma, dbeta, dwh) as ``_tail_bwd_plain``."""
    dwe, dwh, dg, db = red.split([patch_size * C * C, C * F, C, C])
    return dwe.reshape(C, patch_size * C), dg, db, dwh.reshape(C, F)


def _bwd_f32_steps_composed(wh, patch_size, rows):
    """The reduction step on the f32 tile step's (dx, partial rows): (dx, dwe, dgamma,
    dbeta, dwh) as ``_tail_bwd_plain``."""
    C, F = wh.shape
    dx, part = rows
    return (dx,) + split_f32_bwd_row(reduce_rows_plain(part), C, F, patch_size)


def final_head_loss_bwd_rows_f32_plain(x, we, gamma, beta, wh, y, welem, scale, *,
                                       patch_size, grid):
    """Plain twin of the f32 K7's tile kernel on ``grid`` persistent blocks (tiles as
    ``final_head_loss_partials_plain``), x f32: (dx (T, C) f32, the partial rows (grid,
    p*C*C + C*F + 2*C) f32, [dWe (C x p*C) | dWh (C x F) | dgamma | dbeta] over each
    block's rows; dWe's columns i*C .. are x^T dh of sub-pixel i)."""
    return _bwd_rows_f32_plain(x, we, gamma, beta, wh, _ce_dlogits(y, welem, scale, x.dtype),
                               patch_size=patch_size, grid=grid)


def final_head_loss_bwd_sequence_f32_plain(x, we, gamma, beta, wh, y, welem, scale, *,
                                           patch_size, grid):
    """The f32 K7's two steps' twins composed (the tile step, ``reduce_rows_plain``):
    results as ``final_head_loss_bwd_plain``."""
    return _bwd_f32_steps_composed(wh, patch_size, final_head_loss_bwd_rows_f32_plain(
        x, we, gamma, beta, wh, y, welem, scale, patch_size=patch_size, grid=grid))


def _sign(d):
    """jnp.sign: +-1, and d itself at 0 and NaN (torch.sign sends NaN to 0)."""
    return torch.where(d > 0, 1.0, torch.where(d < 0, -1.0, d))


def _depth_diff(lf, ti):
    """(d, valid) of one sub-pixel: valid = isfinite(target); d = logit 0 - target
    with an invalid target selected to 0 first, and d = 0 where invalid."""
    valid = torch.isfinite(ti)
    return torch.where(valid, lf[:, 0] - torch.where(valid, ti, 0.0), 0.0), valid


def _depth_loss_vals(lf, ti, kind, delta):
    """Per-element loss of one sub-pixel, 0 where invalid.  lf: (T, F) f32 logits;
    ti: (T,) f32 targets.  As ``_depth_loss_vals`` of the JAX package."""
    d, valid = _depth_diff(lf, ti)
    if kind == "l2":
        v = 0.5 * d * d
    elif kind == "l1":
        v = torch.abs(d)
    elif kind == "huber":
        ad = torch.abs(d)
        v = torch.where(ad < delta, 0.5 * ad * ad / delta, ad - 0.5 * delta)
    elif kind == "nll":
        lv = torch.where(valid, lf[:, 1], 0.0)
        v = 0.5 * lv + (0.5 * d * d) * torch.exp(-lv)
    else:
        raise ValueError(f"unknown depth loss kind {kind!r}")
    return torch.where(valid, v, 0.0), valid


def _depth_loss_grads(lf, ti, kind, delta):
    """d loss / d logits of one sub-pixel: (T, F) f32, 0 where invalid.  With F = 2
    and a kind other than nll the logvar channel gets 0."""
    d, valid = _depth_diff(lf, ti)
    g1 = torch.zeros_like(d)
    if kind == "l2":
        g0 = d
    elif kind == "l1":
        g0 = _sign(d)
    elif kind == "huber":
        g0 = torch.where(torch.abs(d) < delta, d / delta, _sign(d))
    elif kind == "nll":
        e = torch.exp(-torch.where(valid, lf[:, 1], 0.0))
        g0 = d * e
        g1 = torch.where(valid, 0.5 - (0.5 * d * d) * e, 0.0)
    else:
        raise ValueError(f"unknown depth loss kind {kind!r}")
    g = torch.stack([torch.where(valid, g0, 0.0), g1], dim=-1)
    return g[:, :lf.shape[-1]]


def final_head_depth_loss_plain(x, we, gamma, beta, wh, t, *, patch_size, loss_kind,
                                huber_delta=1.0):
    """Plain version of K8.  wh: (C, F), F in {1, 2}; t: (T, p) f32 targets, a
    non-finite value marking background.  Returns (sum loss, count of valid targets,
    both 0-d f32, and the predictions (T, p*F) in x's dtype, column i*F + f holding
    channel f of sub-pixel i)."""
    we_s = _split_we(we, x.dtype, patch_size)
    whf = wh.to(x.dtype).float()
    num = torch.zeros((), dtype=torch.float32, device=x.device)
    den = torch.zeros((), dtype=torch.float32, device=x.device)
    preds = []
    for i in range(patch_size):
        lf = _sub_rows(x, we_s, gamma, beta, i)[0] @ whf
        vals, valid = _depth_loss_vals(lf, t[:, i].float(), loss_kind, huber_delta)
        num = num + vals.sum()
        den = den + valid.float().sum()
        preds.append(lf)
    return num, den, torch.stack(preds, dim=1).reshape(x.shape[0], -1).to(x.dtype)


def _depth_dlogits(t, scale, kind, delta):
    """K9's dlogits of sub-pixel i: scale * dloss/dlogits of the f32 logits, f32; a
    ``dlogits_of`` of ``_tail_bwd_slices``."""

    def dlogits_of(i, z, whf):
        return scale * _depth_loss_grads(z @ whf, t[:, i].float(), kind, delta)

    return dlogits_of


def final_head_depth_loss_bwd_plain(x, we, gamma, beta, wh, t, scale, *, patch_size,
                                    loss_kind, huber_delta=1.0):
    """Plain version of K9, the backward of K8 for loss gradient ``gloss``:
    scale = gloss / max(count, 1) (a 0-d f32 tensor); dlogits = scale * dloss/dlogits
    stay f32.  Results as ``_tail_bwd_plain``."""
    return _tail_bwd_plain(x, we, gamma, beta, wh,
                           _depth_dlogits(t, scale, loss_kind, huber_delta),
                           patch_size=patch_size)


def final_head_depth_loss_partials_plain(x, we, gamma, beta, wh, t, *, patch_size, loss_kind,
                                         huber_delta=1.0, grid):
    """Plain twin of K8's partial rows on ``grid`` persistent blocks (tiles as
    ``final_head_loss_partials_plain``): (grid, 2) f32, each row [sum loss, count of
    valid targets] over the block's rows; their sum over the blocks is
    ``final_head_depth_loss_plain``'s (sum loss, count)."""
    we_s = _split_we(we, x.dtype, patch_size)
    whf = wh.to(x.dtype).float()
    num = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    den = torch.zeros_like(num)
    for i in range(patch_size):
        lf = _sub_rows(x, we_s, gamma, beta, i)[0] @ whf
        vals, valid = _depth_loss_vals(lf, t[:, i].float(), loss_kind, huber_delta)
        num = num + vals
        den = den + valid.float()
    return torch.stack([_block_sums(num, grid), _block_sums(den, grid)], dim=1)


def final_head_depth_loss_bwd_rows_plain(x, we, gamma, beta, wh, t, scale, *, patch_size,
                                         loss_kind, huber_delta=1.0, grid):
    """Plain twin of the first step of the bf16 K9's launch sequence, its row kernel on
    ``grid`` persistent blocks: (dx, dh, partial rows [dWh (C x F) | dgamma | dbeta]) as
    ``final_head_loss_bwd_rows_plain``, from K9's f32 dlogits."""
    return _bwd_rows_plain(x, we, gamma, beta, wh,
                           _depth_dlogits(t, scale, loss_kind, huber_delta),
                           patch_size=patch_size, grid=grid)


def final_head_depth_loss_bwd_sequence_plain(x, we, gamma, beta, wh, t, scale, *,
                                             patch_size, loss_kind, huber_delta=1.0, grid):
    """K9's three steps' twins composed (the row step, ``final_head_loss_dwe_plain``,
    ``reduce_rows_plain``): results as ``final_head_depth_loss_bwd_plain``."""
    return _bwd_steps_composed(x, wh, final_head_depth_loss_bwd_rows_plain(
        x, we, gamma, beta, wh, t, scale, patch_size=patch_size, loss_kind=loss_kind,
        huber_delta=huber_delta, grid=grid))


def final_head_depth_loss_bwd_rows_f32_plain(x, we, gamma, beta, wh, t, scale, *,
                                             patch_size, loss_kind, huber_delta=1.0, grid):
    """Plain twin of the f32 K9's tile kernel on ``grid`` persistent blocks: (dx, partial
    rows [dWe | dWh | dgamma | dbeta]) as ``final_head_loss_bwd_rows_f32_plain``, from
    K9's f32 dlogits."""
    return _bwd_rows_f32_plain(x, we, gamma, beta, wh,
                               _depth_dlogits(t, scale, loss_kind, huber_delta),
                               patch_size=patch_size, grid=grid)


def final_head_depth_loss_bwd_sequence_f32_plain(x, we, gamma, beta, wh, t, scale, *,
                                                 patch_size, loss_kind, huber_delta=1.0,
                                                 grid):
    """The f32 K9's two steps' twins composed: results as
    ``final_head_depth_loss_bwd_plain``."""
    return _bwd_f32_steps_composed(wh, patch_size, final_head_depth_loss_bwd_rows_f32_plain(
        x, we, gamma, beta, wh, t, scale, patch_size=patch_size, loss_kind=loss_kind,
        huber_delta=huber_delta, grid=grid))


def _tail_refusal(what, T, C, F, max_f=KERNEL_MAX_F):
    """Why the tail kernels (K3, K6-K9, all on the row core, and the f32 K6-K9) do not
    take T tokens of width C with F outputs, or None where they do: C one of 32, 64, 96,
    128, 1 <= F <= ``max_f`` (32; 16 for the f32 kernels), T % 64.  The dtype and the
    shared memory are checked at the call (``_tail_operands``)."""
    if C % 16 or not 1 <= F <= max_f:
        return f"{what}: the kernel takes C % 16 == 0 and F <= {max_f}, got C={C}, F={F}"
    if T % KERNEL_ROWS:
        return f"{what}: T={T} is not a multiple of {KERNEL_ROWS}"
    if C > KERNEL_MAX_C_LOSS_BWD:
        return f"{what}: the kernel takes C <= {KERNEL_MAX_C_LOSS_BWD}, got C={C}"
    if C not in KERNEL_LOSS_CS:
        return f"{what}: the kernel takes C % 32 == 0 and C <= 128, got C={C}"
    return None


def kernels_take(T, C, F, dtype, train=True) -> bool:
    """Whether the segmentation tail's kernels take T tokens of width C, F classes and
    ``dtype``: K6 and K7 both (``train``) or K3 (predict); the answer is the same either
    way, since K3 runs on their row cores, bf16 and f32 (their f32 kernels, F <= 16).
    The wrappers' checks apart from the shared memory, which they read from the kernels'
    library at the call (K7 at C 128 needs p <= 2); where False, a CUDA tensor raises
    under "auto" and "pallas" and needs impl="xla", the plain version."""
    if dtype == torch.float32:
        return _tail_refusal("", T, C, F, KERNEL_MAX_F_F32) is None
    return dtype == torch.bfloat16 and _tail_refusal("", T, C, F) is None


def _tail_operands(what, x, we, gamma, beta, wh, patch_size, kernel):
    """The checked operands of the tail kernel ``kernel`` ("predict", "loss",
    "loss_bwd", "depth_loss" or "depth_loss_bwd", as the library names its
    shared-memory figures; x f32 takes the f32 variant):
    (T, C, F, we_s (p, C, C), gamma, beta, wh), the weights in x's dtype."""
    T, C = x.shape
    p = patch_size
    F = wh.shape[-1]
    who = f"{what} ({KERNEL_IDS[kernel]})"
    f32 = x.dtype == torch.float32 and kernel in F32_KERNELS
    if x.dtype != torch.bfloat16 and not f32:
        takes = "bfloat16 or float32" if kernel in F32_KERNELS else "bfloat16"
        refuse(f"{who}: the kernel takes {takes} x, got {x.dtype}")
    msg = _tail_refusal(who, T, C, F, KERNEL_MAX_F_F32 if f32 else KERNEL_MAX_F)
    if msg is not None:
        refuse(msg)
    name = f"{kernel}_f32" if f32 else kernel
    smem = getattr(_build.lib(), f"hs_final_head_{name}_smem")(C, F, p)
    if smem > KERNEL_SMEM_LIMIT:
        refuse(f"{who}: C={C}, p={p} needs {smem} bytes of shared memory")
    dt = x.dtype
    if (tuple(we.shape) != (C, p * C) or tuple(wh.shape) != (C, F)
            or tuple(gamma.shape) != (C,) or tuple(beta.shape) != (C,)):
        raise ValueError(f"{what}: operands must be we (C, p*C), wh (C, F), gamma/beta (C,)")
    ops = (x, _split_we(we, dt, p).contiguous(), gamma.float().contiguous(),
           beta.float().contiguous(), wh.to(dt).contiguous())
    if not all(t.is_cuda and t.device == x.device for t in ops):
        raise ValueError(f"{what}: every operand must be on {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be contiguous and 16-byte aligned")
    return (T, C, F) + ops[1:]


def _targets(what, y, welem, T, p, device):
    if tuple(y.shape) != (T, p) or tuple(welem.shape) != (T, p):
        raise ValueError(f"{what}: y and welem must be (T, p) = {(T, p)}")
    y = y.to(device=device, dtype=torch.int32).contiguous()
    welem = welem.to(device=device, dtype=torch.float32).contiguous()
    return y, welem


def final_head_predict(x, we, gamma, beta, wh, *, patch_size, impl="auto", tap_logits=False):
    """K3 wrapper; operands and result as ``final_head_predict_plain``; x bf16 or f32 (the
    f32 kernel, counted as "final_head_predict_f32").  With ``tap_logits`` (preds, the
    f32 logits (T, p, F) the argmax took): a probe's output, on the card written by the
    kernel beside its classes."""
    if not use_kernel(x, impl):
        lf = final_head_logits_plain(x, we, gamma, beta, wh, patch_size=patch_size)
        preds = argmax_lowest(lf)
        return (preds, lf) if tap_logits else preds
    what = "final_head_predict"
    T, C, F, we_s, g, b, whb = _tail_operands(what, x, we, gamma, beta, wh, patch_size,
                                              "predict")
    p = patch_size
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, we, gamma, beta, wh)):
        raise ValueError(f"{what}: the kernel has no backward; call it under "
                         "torch.no_grad()")
    sfx = f32_suffix(x)
    preds = torch.empty((T, p), dtype=torch.int32, device=x.device)
    tap = torch.empty((T, p, F), dtype=torch.float32, device=x.device) if tap_logits else None
    code = getattr(_build.lib(), f"hs_final_head_predict{sfx}")(
        x.data_ptr(), we_s.data_ptr(), g.data_ptr(), b.data_ptr(), whb.data_ptr(),
        preds.data_ptr(), None if tap is None else tap.data_ptr(), T, C, F, p, LN_EPS,
        stream(x))
    check(code, what + sfx)
    _count(what + sfx, T, C)
    return (preds, tap) if tap_logits else preds


def final_head_loss_sums(x, we, gamma, beta, wh, y, welem, *, patch_size, impl="auto",
                         tap_logits=False):
    """K6 wrapper: (sum w*nll, sum w, confusion matrix); operands as
    ``final_head_loss_plain``; x bf16 or f32 (the f32 kernel, counted as
    "final_head_loss_f32").  With ``tap_logits`` a fourth result, the logits (T, p, F)
    rounded to x's dtype that the cross entropy took (a probe's output: on the card the
    kernel writes them beside its sums)."""
    if not use_kernel(x, impl):
        out = final_head_loss_plain(x, we, gamma, beta, wh, y, welem, patch_size=patch_size)
        if tap_logits:
            out += (final_head_logits_plain(x, we, gamma, beta, wh,
                                            patch_size=patch_size).to(x.dtype),)
        return out
    what = "final_head_loss"
    T, C, F, we_s, g, b, whb = _tail_operands(what, x, we, gamma, beta, wh, patch_size,
                                              "loss")
    p = patch_size
    y, welem = _targets(what, y, welem, T, p, x.device)
    lib = _build.lib()
    sfx = f32_suffix(x)
    red = torch.empty(2 + F * F, dtype=torch.float32, device=x.device)
    work = torch.empty(getattr(lib, f"hs_final_head_loss{sfx}_workspace")(T, C, F, p),
                       dtype=torch.uint8, device=x.device)
    tap = torch.empty((T, p, F), dtype=x.dtype, device=x.device) if tap_logits else None
    code = getattr(lib, f"hs_final_head_loss{sfx}")(
        x.data_ptr(), we_s.data_ptr(), g.data_ptr(), b.data_ptr(), whb.data_ptr(),
        y.data_ptr(), welem.data_ptr(), red.data_ptr(), work.data_ptr(),
        None if tap is None else tap.data_ptr(), T, C, F, p, LN_EPS, stream(x))
    check(code, what + sfx)
    _count(what + sfx, T, C)
    out = (red[0], red[1], red[2:].reshape(F, F))
    return out + (tap,) if tap_logits else out


def _bwd_outputs(x, lib, name, T, C, F, p):
    """A backward entry's outputs: dx, and the f32 reduced row [dWe | dWh | dgamma |
    dbeta] (f32 x) or dwe (C, p*C) and [dWh | dgamma | dbeta] (bf16 x), and its workspace;
    the tensors in the C entry's order."""
    f32 = dict(dtype=torch.float32, device=x.device)
    work = torch.empty(getattr(lib, f"hs_{name}_workspace")(T, C, F, p), dtype=torch.uint8,
                       device=x.device)
    if x.dtype == torch.float32:
        return (torch.empty_like(x), torch.empty(p * C * C + C * F + 2 * C, **f32), work)
    return (torch.empty_like(x), torch.empty((C, p * C), **f32),
            torch.empty(C * F + 2 * C, **f32), work)


def _bwd_results(x, outs, C, F, p):
    """(dx, dwe, dgamma, dbeta, dwh) from ``_bwd_outputs``' tensors after the launch."""
    if x.dtype == torch.float32:
        return (outs[0],) + split_f32_bwd_row(outs[1], C, F, p)
    dx, dwe, red, _ = outs
    dwh, dg, db = red.split([C * F, C, C])
    return dx, dwe, dg, db, dwh.reshape(C, F)


def _rows_outputs(x, lib, name, T, C, F, p, tap_logits, tap_dtype):
    """A backward's first step's outputs: dx, (bf16 x) the rounded dh (T, p*C), and the
    partial rows on the kernel's grid, (f32 x) [dWe | dWh | dgamma | dbeta] a block,
    (bf16 x) [dWh | dgamma | dbeta]; then the logits tap or None."""
    grid = getattr(lib, f"hs_{name}_grid")(T, C, F, p)
    if grid < 1:
        raise RuntimeError(f"{name}: no grid for T={T}, C={C}, F={F}, p={p}")
    tap = (torch.empty((T, p, F), dtype=tap_dtype, device=x.device) if tap_logits else None)
    if x.dtype == torch.float32:
        part = torch.empty((grid, p * C * C + C * F + 2 * C), dtype=torch.float32,
                           device=x.device)
        return (torch.empty_like(x), part), tap
    dh = torch.empty((T, p * C), dtype=x.dtype, device=x.device)
    part = torch.empty((grid, C * F + 2 * C), dtype=torch.float32, device=x.device)
    return (torch.empty_like(x), dh, part), tap


def final_head_loss_bwd(x, we, gamma, beta, wh, y, welem, scale, *, patch_size, impl="auto"):
    """K7 wrapper: the backward of K6, one entry that launches its sequence (bf16 x: the
    row kernel, ``reduce_rows`` over its partial rows, ``gemm_tn`` for dWe; f32 x: the
    f32 tile kernel, dWe among its partial rows, and ``reduce_rows``, counted as
    "final_head_loss_bwd_f32"); operands and results as ``final_head_loss_bwd_plain``."""
    if not use_kernel(x, impl):
        return final_head_loss_bwd_plain(x, we, gamma, beta, wh, y, welem, scale,
                                         patch_size=patch_size)
    what = "final_head_loss_bwd"
    T, C, F, we_s, g, b, whb = _tail_operands(what, x, we, gamma, beta, wh, patch_size,
                                              "loss_bwd")
    p = patch_size
    y, welem = _targets(what, y, welem, T, p, x.device)
    scale = scale.to(device=x.device, dtype=torch.float32).reshape(1).contiguous()
    lib = _build.lib()
    sfx = f32_suffix(x)
    outs = _bwd_outputs(x, lib, f"final_head_loss_bwd{sfx}", T, C, F, p)
    code = getattr(lib, f"hs_final_head_loss_bwd{sfx}")(
        x.data_ptr(), we_s.data_ptr(), g.data_ptr(), b.data_ptr(), whb.data_ptr(),
        y.data_ptr(), welem.data_ptr(), scale.data_ptr(), *(o.data_ptr() for o in outs),
        T, C, F, p, LN_EPS, stream(x))
    check(code, what + sfx)
    _count(what + sfx, T, C)
    return _bwd_results(x, outs, C, F, p)


def final_head_loss_bwd_rows(x, we, gamma, beta, wh, y, welem, scale, *, patch_size,
                             impl="auto", tap_logits=False):
    """K7's first step alone (not counted, as K7's launches count the sequence), on the
    kernel's grid (one block for CPU tensors): for bf16 x its row kernel, (dx, dh,
    partial rows) as ``final_head_loss_bwd_rows_plain``; for f32 x its tile kernel, (dx,
    partial rows) as ``final_head_loss_bwd_rows_f32_plain``; with ``tap_logits`` the
    logits (T, p, F) in x's dtype it recomputed."""
    if not use_kernel(x, impl):
        twin = (final_head_loss_bwd_rows_f32_plain if x.dtype == torch.float32
                else final_head_loss_bwd_rows_plain)
        out = twin(x, we, gamma, beta, wh, y, welem, scale, patch_size=patch_size, grid=1)
        if tap_logits:
            out += (final_head_logits_plain(x, we, gamma, beta, wh,
                                            patch_size=patch_size).to(x.dtype),)
        return out
    what = "final_head_loss_bwd_rows"
    T, C, F, we_s, g, b, whb = _tail_operands(what, x, we, gamma, beta, wh, patch_size,
                                              "loss_bwd")
    p = patch_size
    y, welem = _targets(what, y, welem, T, p, x.device)
    scale = scale.to(device=x.device, dtype=torch.float32).reshape(1).contiguous()
    lib = _build.lib()
    sfx = f32_suffix(x)
    outs, tap = _rows_outputs(x, lib, f"final_head_loss_bwd{sfx}", T, C, F, p, tap_logits,
                              x.dtype)
    code = getattr(lib, f"hs_final_head_loss_bwd{sfx}_rows")(
        x.data_ptr(), we_s.data_ptr(), g.data_ptr(), b.data_ptr(), whb.data_ptr(),
        y.data_ptr(), welem.data_ptr(), scale.data_ptr(), *(o.data_ptr() for o in outs),
        None if tap is None else tap.data_ptr(), T, C, F, p, LN_EPS, stream(x))
    check(code, what)
    return outs + (tap,) if tap_logits else outs


def final_head_loss_dwe(x, dh, *, impl="auto"):
    """The dWe step of the bf16 K7's and K9's sequences alone, ``gemm_tn``: dWe = x^T dh
    (C, p*C) f32; operands as ``final_head_loss_dwe_plain`` (not counted).  The f32
    kernels have no such step: their tile kernel forms dWe on the chip."""
    if not use_kernel(x, impl):
        return final_head_loss_dwe_plain(x, dh)
    what = "final_head_loss_dwe"
    T, C = x.shape
    N = dh.shape[1]
    if (x.dtype != torch.bfloat16 or dh.dtype != x.dtype or dh.shape[0] != T
            or T % KERNEL_ROWS or C % 16 or N % 16 or not dh.is_cuda):
        raise ValueError(f"{what}: the kernel takes bf16 x (T, C) and dh (T, N), T % 64, "
                         f"C % 16, N % 16, on one device; got {tuple(x.shape)} {x.dtype} "
                         f"{tuple(dh.shape)} {dh.dtype}")
    lib = _build.lib()
    x, dh = x.contiguous(), dh.contiguous()
    out = torch.empty((C, N), dtype=torch.float32, device=x.device)
    work = torch.empty(lib.hs_gemm_tn_workspace(T, C, N), dtype=torch.uint8, device=x.device)
    check(lib.hs_gemm_tn(x.data_ptr(), dh.data_ptr(), out.data_ptr(), work.data_ptr(), T, C,
                         N, stream(x)), what)
    return out


def reduce_rows(part, *, impl="auto"):
    """The reduction step of K7's and K9's sequences alone: the sum of the partial rows
    (R, N) f32 over the rows, in a fixed order; operands as ``reduce_rows_plain`` (not
    counted)."""
    if not use_kernel(part, impl):
        return reduce_rows_plain(part)
    if part.dtype != torch.float32 or part.dim() != 2:
        raise ValueError(f"reduce_rows: the kernel takes (R, N) f32, got {part.dtype} "
                         f"{tuple(part.shape)}")
    lib = _build.lib()
    R, N = part.shape
    part = part.contiguous()
    out = torch.empty(N, dtype=torch.float32, device=part.device)
    work = torch.empty(max(lib.hs_reduce_rows_workspace(R, N), 1), dtype=torch.uint8,
                       device=part.device)
    check(lib.hs_reduce_rows(part.data_ptr(), out.data_ptr(), work.data_ptr(), R, N,
                             stream(part)), "reduce_rows")
    return out


def _depth_refusal(what, F, kind):
    """Why K8/K9 do not take loss ``kind`` with F output channels, or None where they
    do (the shapes: ``_tail_refusal``)."""
    if kind not in DEPTH_KINDS:
        return f"{what}: unknown loss kind {kind!r}; the kernel takes {DEPTH_KINDS}"
    if F not in (1, 2):
        return f"{what}: the kernel takes F in (1, 2) output channels, got F={F}"
    if kind == "nll" and F != 2:
        return f"{what}: the nll loss needs F=2 (mean, logvar), got F={F}"
    return None


def depth_kernels_take(T, C, F, kind, dtype=torch.bfloat16) -> bool:
    """Whether K8 and K9 take a depth tail of T tokens of width C, F output channels,
    loss ``kind`` and ``dtype``: bf16 (the tail row core) or f32 (their f32 kernels), C
    one of 32, 64, 96, 128 (one instantiation each), T % 64.  The shared memory is
    checked at the call, where a tail the kernels do not take raises."""
    return (dtype in (torch.bfloat16, torch.float32) and _depth_refusal("", F, kind) is None
            and _tail_refusal("", T, C, F) is None)


def depth_route_takes(T, C, F, kind) -> bool:
    """The depth task's gate of its fused route: the loss kinds and heads the fused
    function computes, on tails of C % 16 == 0 up to 128 and T % 64 == 0.  Its
    kernels take a subset of these (``depth_kernels_take``); on a CUDA tensor a tail
    the gate admits and the kernels do not take raises, naming impl="xla", as the
    segmentation tail does."""
    return (_depth_refusal("", F, kind) is None and not C % 16 and C <= KERNEL_MAX_C_LOSS_BWD
            and not T % KERNEL_ROWS)


def _depth_operands(what, x, we, gamma, beta, wh, t, patch_size, kind, kernel):
    msg = _depth_refusal(what, wh.shape[-1], kind)
    if msg is not None:
        refuse(msg)
    ops = _tail_operands(what, x, we, gamma, beta, wh, patch_size, kernel)
    if tuple(t.shape) != (ops[0], patch_size):
        raise ValueError(f"{what}: t must be (T, p) = {(ops[0], patch_size)}")
    return ops + (t.to(device=x.device, dtype=torch.float32).contiguous(),)


def final_head_depth_loss_sums(x, we, gamma, beta, wh, t, *, patch_size, loss_kind,
                               huber_delta=1.0, impl="auto", tap_logits=False):
    """K8 wrapper: (sum loss, count of valid targets, predictions (T, p*F)); operands
    as ``final_head_depth_loss_plain``; x bf16 or f32 (the f32 kernel, counted as
    "final_head_depth_loss_f32").  With ``tap_logits`` a fourth result, the f32 logits
    (T, p, F) the loss took (a probe's output: on the card the kernel writes them beside
    its sums)."""
    kw = dict(patch_size=patch_size, loss_kind=loss_kind, huber_delta=huber_delta)
    if not use_kernel(x, impl):
        out = final_head_depth_loss_plain(x, we, gamma, beta, wh, t, **kw)
        if tap_logits:
            out += (final_head_logits_plain(x, we, gamma, beta, wh, patch_size=patch_size),)
        return out
    what = "final_head_depth_loss"
    T, C, F, we_s, g, b, whb, t = _depth_operands(what, x, we, gamma, beta, wh, t,
                                                  patch_size, loss_kind, "depth_loss")
    p = patch_size
    lib = _build.lib()
    sfx = f32_suffix(x)
    red = torch.empty(2, dtype=torch.float32, device=x.device)
    preds = torch.empty((T, p * F), dtype=x.dtype, device=x.device)
    work = torch.empty(getattr(lib, f"hs_final_head_depth_loss{sfx}_workspace")(T, C, F, p),
                       dtype=torch.uint8, device=x.device)
    tap = torch.empty((T, p, F), dtype=torch.float32, device=x.device) if tap_logits else None
    code = getattr(lib, f"hs_final_head_depth_loss{sfx}")(
        x.data_ptr(), we_s.data_ptr(), g.data_ptr(), b.data_ptr(), whb.data_ptr(),
        t.data_ptr(), red.data_ptr(), preds.data_ptr(), work.data_ptr(),
        None if tap is None else tap.data_ptr(), T, C, F, p, DEPTH_KINDS.index(loss_kind),
        LN_EPS, float(huber_delta), stream(x))
    check(code, what + sfx)
    _count(what + sfx, T, C, F, loss_kind)
    out = (red[0], red[1], preds)
    return out + (tap,) if tap_logits else out


def final_head_depth_loss_bwd(x, we, gamma, beta, wh, t, scale, *, patch_size, loss_kind,
                              huber_delta=1.0, impl="auto"):
    """K9 wrapper: the backward of K8, one entry that launches its sequence (bf16 x: the
    row kernel, ``gemm_tn`` for dWe, ``reduce_rows`` over the partial rows; f32 x: the
    f32 tile kernel, dWe among its partial rows, and ``reduce_rows``, counted as
    "final_head_depth_loss_bwd_f32"); operands and results as
    ``final_head_depth_loss_bwd_plain``."""
    kw = dict(patch_size=patch_size, loss_kind=loss_kind, huber_delta=huber_delta)
    if not use_kernel(x, impl):
        return final_head_depth_loss_bwd_plain(x, we, gamma, beta, wh, t, scale, **kw)
    what = "final_head_depth_loss_bwd"
    T, C, F, we_s, g, b, whb, t = _depth_operands(what, x, we, gamma, beta, wh, t,
                                                  patch_size, loss_kind, "depth_loss_bwd")
    p = patch_size
    scale = scale.to(device=x.device, dtype=torch.float32).reshape(1).contiguous()
    lib = _build.lib()
    sfx = f32_suffix(x)
    outs = _bwd_outputs(x, lib, f"final_head_depth_loss_bwd{sfx}", T, C, F, p)
    code = getattr(lib, f"hs_final_head_depth_loss_bwd{sfx}")(
        x.data_ptr(), we_s.data_ptr(), g.data_ptr(), b.data_ptr(), whb.data_ptr(),
        t.data_ptr(), scale.data_ptr(), *(o.data_ptr() for o in outs), T, C, F, p,
        DEPTH_KINDS.index(loss_kind), LN_EPS, float(huber_delta), stream(x))
    check(code, what + sfx)
    _count(what + sfx, T, C, F, loss_kind)
    return _bwd_results(x, outs, C, F, p)


def final_head_depth_loss_bwd_rows(x, we, gamma, beta, wh, t, scale, *, patch_size,
                                   loss_kind, huber_delta=1.0, impl="auto", tap_logits=False):
    """K9's first step alone (not counted, as K9's launches count the sequence), on the
    kernel's grid (one block for CPU tensors): for bf16 x its row kernel, (dx, dh,
    partial rows) as ``final_head_depth_loss_bwd_rows_plain``; for f32 x its tile kernel,
    (dx, partial rows) as ``final_head_depth_loss_bwd_rows_f32_plain``; with
    ``tap_logits`` the f32 logits (T, p, F) it recomputed."""
    kw = dict(patch_size=patch_size, loss_kind=loss_kind, huber_delta=huber_delta)
    if not use_kernel(x, impl):
        twin = (final_head_depth_loss_bwd_rows_f32_plain if x.dtype == torch.float32
                else final_head_depth_loss_bwd_rows_plain)
        out = twin(x, we, gamma, beta, wh, t, scale, **kw, grid=1)
        if tap_logits:
            out += (final_head_logits_plain(x, we, gamma, beta, wh, patch_size=patch_size),)
        return out
    what = "final_head_depth_loss_bwd_rows"
    T, C, F, we_s, g, b, whb, t = _depth_operands(what, x, we, gamma, beta, wh, t,
                                                  patch_size, loss_kind, "depth_loss_bwd")
    p = patch_size
    scale = scale.to(device=x.device, dtype=torch.float32).reshape(1).contiguous()
    lib = _build.lib()
    sfx = f32_suffix(x)
    outs, tap = _rows_outputs(x, lib, f"final_head_depth_loss_bwd{sfx}", T, C, F, p,
                              tap_logits, torch.float32)
    code = getattr(lib, f"hs_final_head_depth_loss_bwd{sfx}_rows")(
        x.data_ptr(), we_s.data_ptr(), g.data_ptr(), b.data_ptr(), whb.data_ptr(),
        t.data_ptr(), scale.data_ptr(), *(o.data_ptr() for o in outs),
        None if tap is None else tap.data_ptr(), T, C, F, p, DEPTH_KINDS.index(loss_kind),
        LN_EPS, float(huber_delta), stream(x))
    check(code, what)
    return outs + (tap,) if tap_logits else outs


def _tail_grads(ctx, operands, grads):
    """The tail operands' gradients, each in its operand's dtype (f32 parameters stay
    f32), None where autograd needs none."""
    return tuple(g.to(o.dtype) if need else None
                 for need, o, g in zip(ctx.needs_input_grad, operands, grads))


class _FinalHeadLoss(torch.autograd.Function):
    """K6 forward, K7 backward (or their plain versions, by ``impl`` and device)."""

    @staticmethod
    def forward(ctx, x, we, gamma, beta, wh, y, welem, patch_size, impl):
        num, den, cm = final_head_loss_sums(x, we, gamma, beta, wh, y, welem,
                                            patch_size=patch_size, impl=impl)
        den_s = torch.clamp_min(den, 1e-12)
        ctx.save_for_backward(x, we, gamma, beta, wh, y, welem, den_s)
        ctx.patch_size, ctx.impl = patch_size, impl
        ctx.mark_non_differentiable(cm)
        return num / den_s, cm

    @staticmethod
    def backward(ctx, gloss, _gcm):
        x, we, gamma, beta, wh, y, welem, den_s = ctx.saved_tensors
        scale = (gloss / den_s).float()
        grads = final_head_loss_bwd(x, we, gamma, beta, wh, y, welem, scale,
                                    patch_size=ctx.patch_size, impl=ctx.impl)
        return _tail_grads(ctx, (x, we, gamma, beta, wh), grads) + (None,) * 4


def final_head_loss(x, we, gamma, beta, wh, y, welem, *, patch_size, impl="auto"):
    """Fused expand -> LN -> head -> weighted CE: (loss, confusion matrix (F, F) f32).
    x: (T, C) tokens after ``norm_up``; we: (C, p*C) expand weight (JAX layout);
    gamma/beta: (C,) LN parameters; wh: (C, F) head weight; y: (T, p) int targets;
    welem: (T, p) f32 per-element weights.  K6 forward, K7 backward; the weights'
    gradients come back in their own dtype (f32 parameters stay f32)."""
    return _FinalHeadLoss.apply(x, we, gamma, beta, wh, y, welem, patch_size, impl)


class _FinalHeadDepthLoss(torch.autograd.Function):
    """K8 forward, K9 backward (or their plain versions, by ``impl`` and device)."""

    @staticmethod
    def forward(ctx, x, we, gamma, beta, wh, t, patch_size, loss_kind, huber_delta, impl):
        ctx.kw = dict(patch_size=patch_size, loss_kind=loss_kind, huber_delta=huber_delta,
                      impl=impl)
        num, den, preds = final_head_depth_loss_sums(x, we, gamma, beta, wh, t, **ctx.kw)
        den_s = torch.clamp_min(den, 1.0)  # the unfused losses' max(count, 1)
        ctx.save_for_backward(x, we, gamma, beta, wh, t, den_s)
        ctx.mark_non_differentiable(preds)  # a metrics tap
        return num / den_s, preds

    @staticmethod
    def backward(ctx, gloss, _gpreds):
        x, we, gamma, beta, wh, t, den_s = ctx.saved_tensors
        scale = (gloss / den_s).float()  # stays on the device: no host sync
        grads = final_head_depth_loss_bwd(x, we, gamma, beta, wh, t, scale, **ctx.kw)
        return _tail_grads(ctx, (x, we, gamma, beta, wh), grads) + (None,) * 5


def final_head_depth_loss(x, we, gamma, beta, wh, t, *, patch_size, loss_kind,
                          huber_delta=1.0, impl="auto"):
    """Fused expand -> LN -> head -> masked depth loss: (loss, predictions (T, p*F) in
    x's dtype, no gradient).  x, we, gamma, beta as ``final_head_loss``; wh: (C, F)
    head weight, F in {1, 2}; t: (T, p) f32 network-space targets, a non-finite value
    marking background; loss_kind: "l2" | "l1" | "huber" | "nll" (nll needs F = 2;
    with F = 2 and another kind the logvar channel gets no gradient).  The loss is
    sum loss / max(count of valid targets, 1).  K8 forward, K9 backward."""
    return _FinalHeadDepthLoss.apply(x, we, gamma, beta, wh, t, patch_size, loss_kind,
                                     huber_delta, impl)
