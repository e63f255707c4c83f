"""Shifted-window strategies on the nested HEALPix pixel sequence (the port's copy of
``heal_swin_tpu/ops/shifting.py``, numpy only).

All three strategies of the reference (``heal_swin/models_torch/hp_shifting.py``) are
host-side precompute that emits a :class:`ShiftSpec`: either a 1-D roll amount or an
index permutation (plus its inverse), together with per-pixel group ids from which the
additive attention mask is derived.  The model applies the shift as a roll or a token
gather, and the attention kernels compare group ids instead of storing the (nW, ws, ws)
bias.

Behavioral parity targets:
- ``NestRollShift``: reference ``hp_shifting.py:42-73``
- ``NestGridShift``: reference ``hp_shifting.py:76-306`` (base_pix=8 only)
- ``RingShift``:     reference ``hp_shifting.py:309-404``
- mask semantics (group-difference -> -100 additive bias): ``hp_shifting.py:10-28``
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np

from heal_swin_torch.ops import healpix as hpx

MASK_VALUE = -100.0  # additive logit penalty, matches reference get_attn_mask_from_mask


@dataclass(frozen=True)
class ShiftSpec:
    """Host-precomputed description of one shift strategy at one resolution.

    shifted[i] = x[perm[i]] for kind == "perm"; for kind == "roll" the shift is
    ``roll(x, -roll_amount)`` and shift_back is ``roll(x, +roll_amount)``.
    ``win_groups`` has shape (nW, ws): integer group id per pixel; attention between
    pixels of different groups within a window is masked.  None means no mask.
    """

    kind: str  # "none" | "roll" | "perm"
    npix: int
    window_size: int
    roll_amount: int = 0
    perm: Optional[np.ndarray] = None
    inv_perm: Optional[np.ndarray] = None
    win_groups: Optional[np.ndarray] = None

    def attn_bias(self, dtype=np.float32) -> Optional[np.ndarray]:
        """Materialize the (nW, ws, ws) additive bias (mainly for tests)."""
        if self.win_groups is None:
            return None
        g = self.win_groups
        return np.where(g[:, :, None] != g[:, None, :], MASK_VALUE, 0.0).astype(dtype)


def _window_groups(pixel_groups: np.ndarray, window_size: int) -> np.ndarray:
    return pixel_groups.reshape(-1, window_size).astype(np.int32)


def no_shift(npix: int, window_size: int) -> ShiftSpec:
    return ShiftSpec(kind="none", npix=npix, window_size=window_size)


def nest_roll_shift(npix: int, window_size: int, shift_size: int) -> ShiftSpec:
    """1-D cyclic roll of the nested sequence by -shift_size (reference NestRollShift).

    Mask: three slices — interior full windows (group 0), carried-over pixels just
    before the wrap (group 1), wrapped pixels (group 2).
    """
    groups = np.zeros(npix, dtype=np.int32)
    groups[-window_size : -shift_size] = 1
    groups[-shift_size:] = 2
    return ShiftSpec(
        kind="roll",
        npix=npix,
        window_size=window_size,
        roll_amount=shift_size,
        win_groups=_window_groups(groups, window_size),
    )


# ---------------------------------------------------------------------------
# NestGridShift
# ---------------------------------------------------------------------------


def _log4(x: int) -> int:
    return int(round(np.log(x) / np.log(4)))


class _NestGridBuilder:
    """Implements the scale-climbing offset computation of the reference NestGridShift.

    The nested hierarchy is a 4-ary tree per base pixel; shifting by half a window along
    grid direction 1 (resp. 2) requires, for each window, finding the sequence position
    of the spatially adjacent block, which means climbing the tree until the current
    block is not the first child in that direction.  Crossing base-pixel borders uses
    the fixed neighbor offsets of the 8-base-pixel (half-sphere) configuration.
    """

    def __init__(self, nside: int, base_pix: int, window_size: int):
        assert base_pix == 8, "NestGridShift is only defined for 8 base pixels"
        self.nside = nside
        self.ws = window_size
        self.base_pix = base_pix
        self.npix = base_pix * nside**2
        self.n_windows = self.npix // self.ws
        self.base_pix_len = (self.npix // base_pix) // self.ws
        self.hws = self.ws // 2
        self.qws = self.hws // 2

    def _get_scale(self, idx: int) -> int:
        assert idx % self.ws == 0
        w_idx = idx // self.ws
        scale = self.base_pix_len
        while w_idx % scale != 0:
            scale //= 4
        return _log4(scale)

    def _offset_dir1(self, idx: int) -> int:
        assert idx % self.ws == 0
        BASE_PIX_OFFSETS = {0: 2, 1: 2, 2: 2, 3: 6, 4: 3, 5: 3, 6: 3, 7: 3}
        while True:
            scale = self._get_scale(idx)
            idx -= self.ws * 4**scale
            if scale >= self._get_scale(idx):
                break
        offset = sum(self.ws * 4**p for p in range(scale + 1))
        if scale == _log4(self.base_pix_len):
            idx += self.ws * 4**scale
            offset -= self.base_pix_len * self.ws
            bp = idx // (self.base_pix_len * self.ws)
            offset += BASE_PIX_OFFSETS[bp] * self.base_pix_len * self.ws
        return offset

    def _offset_dir2(self, idx: int) -> int:
        assert idx % self.ws == 0
        BASE_PIX_OFFSETS = {i: 3 for i in range(8)}
        scale = self._get_scale(idx)
        while (idx % (self.ws * 4 ** (scale + 1))) // (self.ws * 4**scale) == 2:
            idx -= 2 * self.ws * 4**scale
            scale = self._get_scale(idx)
        offset = sum(2 * self.ws * 4**p for p in range(scale))
        if scale == _log4(self.base_pix_len):
            bp = idx // (self.base_pix_len * self.ws)
            offset += BASE_PIX_OFFSETS[bp] * self.base_pix_len * self.ws
        return offset

    def shifted_idcs_dir1(self) -> np.ndarray:
        ws, hws = self.ws, self.hws
        result = np.zeros(self.npix, dtype=np.int64)
        for w in range(self.n_windows):
            first = w * ws
            os = self._offset_dir1(first)
            result[first : first + hws] = np.arange(first - os - hws, first - os)
            result[first + hws : first + ws] = np.arange(first, first + hws)
        return result % self.npix

    def shifted_idcs_dir2(self) -> np.ndarray:
        ws, hws, qws = self.ws, self.hws, self.qws
        result = np.zeros(self.npix, dtype=np.int64)
        for w in range(self.n_windows):
            first = w * ws
            os = self._offset_dir2(first)
            result[first : first + qws] = np.arange(first - os - hws - qws, first - os - hws)
            result[first + qws : first + hws] = np.arange(first, first + qws)
            result[first + hws : first + hws + qws] = np.arange(first - os - qws, first - os)
            result[first + hws + qws : first + ws] = np.arange(first + hws, first + hws + qws)
        return result % self.npix

    def pixel_groups(self) -> np.ndarray:
        """Per-pixel mask groups (reference NestGridShift.get_mask with get_attn_mask=False)."""
        MASKED_BASE_PIX = [4, 5, 6, 7]
        LEFT_CARRY_OVER_BASE_PIX = [0, 1, 2, 3]
        ws, hws, qws = self.ws, self.hws, self.qws
        mask = np.zeros(self.npix, dtype=np.int32)

        def right_mask_subset(first, size, val):
            if size == ws:
                mask[first : first + qws] = val
                mask[first + hws : first + hws + qws] = val
            else:
                right_mask_subset(first, size // 4, val)
                right_mask_subset(first + 2 * size // 4, size // 4, val)

        def left_mask_subset(first, size, val):
            if size == ws:
                mask[first : first + hws] = val
            else:
                left_mask_subset(first, size // 4, val)
                left_mask_subset(first + size // 4, size // 4, val)

        for b, co in zip(MASKED_BASE_PIX, LEFT_CARRY_OVER_BASE_PIX):
            left_mask_subset(b * self.base_pix_len * ws, self.base_pix_len * ws, b + 1)
            right_mask_subset(
                b * self.base_pix_len * ws,
                self.base_pix_len * ws,
                b + 1 + len(MASKED_BASE_PIX),
            )
            first_co = co * self.base_pix_len * ws
            mask[first_co : first_co + qws] = b + 1
        return mask


def nest_grid_shift(nside: int, base_pix: int, window_size: int) -> ShiftSpec:
    b = _NestGridBuilder(nside, base_pix, window_size)
    perm = b.shifted_idcs_dir1()[b.shifted_idcs_dir2()]
    _validate_perm(perm, b.npix, "nest_grid_shift", nside, window_size)
    inv = np.argsort(perm, kind="stable")
    groups = b.pixel_groups()
    return ShiftSpec(
        kind="perm",
        npix=b.npix,
        window_size=window_size,
        perm=perm,
        inv_perm=inv,
        win_groups=_window_groups(groups, window_size),
    )


# ---------------------------------------------------------------------------
# RingShift
# ---------------------------------------------------------------------------


def ring_shift(nside: int, base_pix: int, window_size: int, shift_size: int) -> ShiftSpec:
    """Shift by converting to ring ordering, rolling, converting back (reference RingShift).

    Pixels whose source lies outside the used ``base_pix * nside**2`` domain are refilled
    with "lost" pixels (used pixels that no longer appear in the map) from a donor base
    pixel, and masked.
    """
    npix_used = base_pix * nside**2
    npix_full = hpx.nside2npix(nside)
    pixel_size = nside**2

    nest_idcs = np.arange(npix_used, dtype=np.int64)
    nest_in_ring = hpx.nest2ring(nside, nest_idcs)
    src_ring = (nest_in_ring - shift_size) % npix_full
    result = hpx.ring2nest(nside, src_ring)

    max_idx = npix_used - 1
    mask = np.zeros(npix_used, dtype=np.int32)
    for i in range(base_pix):
        sl = slice(i * pixel_size, (i + 1) * pixel_size)
        mask[sl][result[sl] > max_idx] = i + 1

    lost_pix = [
        np.setdiff1d(np.arange(i * pixel_size, (i + 1) * pixel_size), result)
        for i in range(base_pix)
    ]

    GET_LOST_FROM = {4: 7, 5: 4, 6: 5, 7: 6}
    unused_source_pix = []
    for i in range(4, base_pix):
        sl = slice(i * pixel_size, (i + 1) * pixel_size)
        sub = result[sl]
        source = lost_pix[GET_LOST_FROM[i]]
        n_fill = int((sub > max_idx).sum())
        assert n_fill <= source.shape[0], f"base pixel {i}: not enough source pixels"
        sub[sub > max_idx] = source[:n_fill]
        unused_source_pix.append(source[n_fill:])
    unused = np.concatenate(unused_source_pix)

    assert unused.shape[0] == int((result > max_idx).sum()), (
        "unused source pixels do not match the number of pixels to be filled"
    )
    first = 0
    for i in range(4):
        sl = slice(i * pixel_size, (i + 1) * pixel_size)
        sub = result[sl]
        n_fill = int((sub > max_idx).sum())
        sub[sub > max_idx] = unused[first : first + n_fill]
        first += n_fill

    _validate_perm(result, npix_used, "ring_shift", nside, window_size)
    inv = np.argsort(result, kind="stable")
    return ShiftSpec(
        kind="perm",
        npix=npix_used,
        window_size=window_size,
        perm=result,
        inv_perm=inv,
        win_groups=_window_groups(mask, window_size),
    )


def _validate_perm(perm: np.ndarray, npix: int, name: str, nside: int, ws: int):
    ok = np.array_equal(np.sort(perm), np.arange(npix))
    assert ok, f"{name} validation failed for nside={nside}, window_size={ws}"


@functools.lru_cache(maxsize=None)
def get_shift_spec(
    strategy: str,
    npix: int,
    base_pix: int,
    window_size: int,
    shift_size: int,
) -> ShiftSpec:
    """Factory mirroring the reference's per-block shifter selection
    (``swin_hp_transformer.py:271-308``).  ``npix`` is the token count at this stage;
    shift_size == 0 yields NoShift."""
    if shift_size == 0:
        return no_shift(npix, window_size)
    if strategy == "nest_roll":
        return nest_roll_shift(npix, window_size, shift_size)
    nside = int(round(np.sqrt(npix // base_pix)))
    assert nside * nside * base_pix == npix, "npix must equal base_pix * nside**2"
    if strategy == "nest_grid_shift":
        return nest_grid_shift(nside, base_pix, window_size)
    if strategy == "ring_shift":
        return ring_shift(nside, base_pix, window_size, shift_size)
    raise ValueError(f"unknown shift strategy: {strategy}")
