"""Fisheye -> HEALPix projection on the device (the port's counterpart of
``heal_swin_tpu/projection/device.py``): batched torch gathers on the images' device.

The reference pre-materializes every projected sample as an .npz on disk
(project_on_s2.py:361-372) because its projection runs on the CPU per calibration.  Here
the geometry is frozen into per-calibration-cluster tables (projection/tables.py) and the
projection itself is a batched gather on the device: the host only decodes flat images.

WoodScape has a handful of distinct intrinsic calibrations per camera, so the tables of
all clusters stack into one (K, ..., npix) tensor and a per-sample ``cal_id`` selects
the row.

``project_images`` is the wide form: one gather of each HEALPix pixel's 2x2 source
patch, 4C values a row (``_remap_wide``), then the weighted sum over the 4 slots.
``project_images_narrow`` gathers the four bilinear neighbours one by one, as
``ForwardTable.apply_image`` does; it is the plain version the wide form is held to.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from heal_swin_torch.projection import tables as T


def _remap_wide(t: "T.ForwardTable"):
    """Remap the 4 clipped bilinear neighbors to (base index, 4 slot weights) in an
    edge-replicated (H+1, W+1) padded geometry.

    ``tables.py`` clips each neighbor independently (``_clip_flat_idx``), but the
    clipped positions always stay inside the 2x2 patch anchored at the clipped floor
    corner: rows {r00, r00+1} x cols {c00, c00+1}, where the +1 entries are
    edge-replicated when the corner sits on the last row/column (clip-to-edge and
    replicate-pad read the same pixel).  So one gather of the 4C-wide patch row replaces
    four C-wide gathers.  Degenerate neighbors (ceil == floor) land on the same slot and
    their weights add."""
    W1 = t.W + 1

    def padded(idx):
        return (idx // t.W) * W1 + (idx % t.W)

    a = padded(t.idx00).astype(np.int32)
    w4 = np.zeros((4, t.npix_used), np.float32)
    slot_of = {0: 0, 1: 1, W1: 2, W1 + 1: 3}
    cols = np.arange(t.npix_used)
    for idx, w in ((t.idx00, t.w00), (t.idx10, t.w10), (t.idx01, t.w01),
                   (t.idx11, t.w11)):
        off = padded(idx) - a
        slots = np.full(off.shape, -1, np.int64)
        for o, s in slot_of.items():
            slots[off == o] = s
        if (slots < 0).any():
            raise AssertionError("bilinear neighbor outside the 2x2 padded patch")
        np.add.at(w4, (slots, cols), w)
    return a, w4


def _batch_index(B: int, device) -> torch.Tensor:
    return torch.arange(B, device=device)[:, None]


def project_images_wide(a, w4, imgs, cal_ids):
    """a: (K, npix) long padded-geometry base indices; w4: (K, 4, npix) f32 slot weights
    (``_remap_wide``); imgs: (B, H, W, C) float; cal_ids: (B,) long.  Returns (B, npix,
    C): the edge-padded images' four shifted views side by side, a (B, M - W1 - 1, 4C)
    patch tensor with M = (H + 1)(W + 1), one row gather from it, and the slots'
    weighted sum."""
    B, H, W, C = imgs.shape
    W1 = W + 1
    M = (H + 1) * W1
    pad = imgs.new_empty((B, H + 1, W1, C))
    pad[:, :H, :W] = imgs
    pad[:, H, :W] = imgs[:, H - 1]
    pad[:, :, W] = pad[:, :, W - 1]
    flat = pad.reshape(B, M, C)
    # row f of q = the 2x2 patch whose corners sit at padded flat offsets
    # {f, f+1, f+W1, f+W1+1}
    q = torch.cat([flat[:, : M - W1 - 1], flat[:, 1 : M - W1],
                   flat[:, W1 : M - 1], flat[:, W1 + 1 :]], dim=-1)
    ab = a[cal_ids]  # (B, npix)
    wb = w4[cal_ids]  # (B, 4, npix)
    g = q[_batch_index(B, imgs.device), ab].reshape(B, ab.shape[1], 4, C)
    out = g[:, :, 0] * wb[:, 0, :, None]
    for k in range(1, 4):
        out = out + g[:, :, k] * wb[:, k, :, None]
    return out


def project_images_narrow(idx, w, imgs, cal_ids):
    """idx / w: (K, 4, npix) long / f32 bilinear neighbours and weights; imgs: (B, H, W,
    C) float; cal_ids: (B,) long.  Returns (B, npix, C): four C-wide gathers and their
    weighted sum (OOB weights are 0)."""
    B, H, W, C = imgs.shape
    flat = imgs.reshape(B, H * W, C)
    ib = idx[cal_ids]  # (B, 4, npix)
    wb = w[cal_ids]
    bi = _batch_index(B, imgs.device)
    out = flat[bi, ib[:, 0]] * wb[:, 0, :, None]
    for k in range(1, 4):
        out = out + flat[bi, ib[:, k]] * wb[:, k, :, None]
    return out


def project_masks(nearest, valid, masks, cal_ids, bkgd):
    """nearest: (K, npix) long; valid: (K, npix) bool; masks: (B, H, W).  Returns (B,
    npix) of the masks' dtype: the nearest sample, ``bkgd`` where off-image."""
    B = masks.shape[0]
    flat = masks.reshape(B, -1)
    out = flat[_batch_index(B, masks.device), nearest[cal_ids]]
    return torch.where(valid[cal_ids], out, torch.tensor(bkgd, dtype=out.dtype,
                                                          device=out.device))


class DeviceProjector:
    """Stacked forward tables for a set of calibration clusters, applied to batches on
    their own device.

    ``project_images`` consumes channels-last (B, H, W, C) float images and returns (B,
    npix_used, C); ``project_masks`` consumes (B, H, W) masks.  The tables stay numpy
    here and are copied to a device on its first batch there."""

    def __init__(self, cal_infos: List[dict], nside: int, base_pix: int = 8,
                 rotate_pole: bool = False):
        tabs = [T.forward_table(c, nside, base_pix, rotate_pole) for c in cal_infos]
        t0 = tabs[0]
        if not all((t.H, t.W, t.npix_used) == (t0.H, t0.W, t0.npix_used) for t in tabs):
            raise ValueError("all calibrations in one projector must share image size and grid")
        self.H, self.W, self.npix_used = t0.H, t0.W, t0.npix_used
        self.n_cals = len(tabs)
        self.idx = np.stack(
            [np.stack([t.idx00, t.idx10, t.idx01, t.idx11]) for t in tabs]
        )  # (K, 4, npix) int32
        self.w = np.stack(
            [np.stack([t.w00, t.w10, t.w01, t.w11]) for t in tabs]
        )  # (K, 4, npix) f32
        wide = [_remap_wide(t) for t in tabs]
        self.wide_a = np.stack([a for a, _ in wide])  # (K, npix) int32
        self.wide_w4 = np.stack([w4 for _, w4 in wide])  # (K, 4, npix) f32
        self.nearest = np.stack([t.nearest_idx for t in tabs])
        self.valid = np.stack([t.nearest_valid for t in tabs])
        self._on: Dict[torch.device, dict] = {}

    def tables(self, device) -> dict:
        """The tables as tensors on ``device`` (indices int64)."""
        device = torch.device(device)
        if device not in self._on:
            long = dict(dtype=torch.long, device=device)
            self._on[device] = dict(
                idx=torch.as_tensor(self.idx, **long),
                w=torch.as_tensor(self.w, device=device),
                wide_a=torch.as_tensor(self.wide_a, **long),
                wide_w4=torch.as_tensor(self.wide_w4, device=device),
                nearest=torch.as_tensor(self.nearest, **long),
                valid=torch.as_tensor(self.valid, device=device))
        return self._on[device]

    def _cal_ids(self, B, cal_ids, device):
        if cal_ids is None:
            return torch.zeros(B, dtype=torch.long, device=device)
        return torch.as_tensor(cal_ids, device=device).long()

    def _check(self, shape):
        if tuple(shape) != (self.H, self.W):
            raise ValueError(f"image size {tuple(shape)}, the tables' {(self.H, self.W)}")

    def project_images(self, imgs: torch.Tensor, cal_ids: Optional[torch.Tensor] = None):
        """(B, H, W, C) float -> (B, npix_used, C): the wide gather."""
        self._check(imgs.shape[1:3])
        t = self.tables(imgs.device)
        return project_images_wide(t["wide_a"], t["wide_w4"], imgs,
                                   self._cal_ids(imgs.shape[0], cal_ids, imgs.device))

    def project_images_narrow(self, imgs: torch.Tensor,
                              cal_ids: Optional[torch.Tensor] = None):
        """(B, H, W, C) float -> (B, npix_used, C): the four-gather plain version."""
        self._check(imgs.shape[1:3])
        t = self.tables(imgs.device)
        return project_images_narrow(t["idx"], t["w"], imgs,
                                     self._cal_ids(imgs.shape[0], cal_ids, imgs.device))

    def project_masks(self, masks: torch.Tensor, cal_ids: Optional[torch.Tensor] = None,
                      s2_bkgd_class=0):
        """(B, H, W) -> (B, npix_used) nearest samples, ``s2_bkgd_class`` off-image."""
        self._check(masks.shape[1:3])
        t = self.tables(masks.device)
        return project_masks(t["nearest"], t["valid"], masks,
                             self._cal_ids(masks.shape[0], cal_ids, masks.device),
                             s2_bkgd_class)
