"""Precomputed projection tables -> gathers (the port's copy of
``heal_swin_tpu/projection/tables.py``; the tables are bit-equal to the JAX package's).

The reference recomputes the fisheye projection per call (CPU, lru-cached per
calibration).  Here the geometry is frozen per (calibration, grid) into index / weight
tables once, and both dataset generation and evaluation back-projection become single
gathers, on the device if desired (``projection/device.py``).

Forward table (flat image -> HP pixels):
    4 bilinear source indices into the flattened (H*W) image + weights per HP pixel,
    plus a nearest-source index for masks and an in-bounds mask.  Matches
    fisheye.sample_bilinear / sample_mask exactly (OOB image samples contribute 0,
    OOB mask samples become the background class).

Backward table (HP pixels -> flat image):
    4 HEALPix bilinear neighbors + weights per output pixel (get_interp_val parity)
    plus the max-weight nearest pixel (get_interp_weights argmax parity).
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass

import numpy as np

from heal_swin_torch.ops import healpix as hpx
from heal_swin_torch.projection import fisheye


@dataclass(frozen=True)
class ForwardTable:
    """flat (C, H, W) image -> (C, npix_used) HP signal."""

    H: int
    W: int
    npix_used: int
    idx00: np.ndarray  # (npix,) int32 flattened v*W+u source indices (clipped)
    idx10: np.ndarray
    idx01: np.ndarray
    idx11: np.ndarray
    w00: np.ndarray  # (npix,) float32, 0 where OOB
    w10: np.ndarray
    w01: np.ndarray
    w11: np.ndarray
    nearest_idx: np.ndarray  # (npix,) int32
    nearest_valid: np.ndarray  # (npix,) bool

    def apply_image(self, img):
        """img: (C, H, W) -> (C, npix) float (numpy arrays)."""
        flat = img.reshape(img.shape[0], -1)
        return (
            flat[:, self.idx00] * self.w00
            + flat[:, self.idx10] * self.w10
            + flat[:, self.idx01] * self.w01
            + flat[:, self.idx11] * self.w11
        )

    def apply_mask(self, mask, s2_bkgd_class):
        flat = mask.reshape(-1)
        out = flat[self.nearest_idx]
        return np.where(self.nearest_valid, out, s2_bkgd_class)


def _clip_flat_idx(x, y, H, W):
    return (np.clip(x, 0, H - 1) * W + np.clip(y, 0, W - 1)).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _forward_table_cached(cal_key, nside, base_pix, rotate_pole):
    cal_info = json.loads(cal_key)
    theta, phi = fisheye.hp_grid_angles(nside, base_pix)
    u, v = fisheye.project_s2_points_to_img(theta, phi, cal_info, rotate_pole)
    H = int(cal_info["intrinsic"]["height"])
    W = int(cal_info["intrinsic"]["width"])
    # match sample_bilinear: rx = v (rows), ry = u (cols)
    rx, ry = v, u
    ix0, iy0 = np.floor(rx).astype(int), np.floor(ry).astype(int)
    ix1, iy1 = np.ceil(rx).astype(int), np.ceil(ry).astype(int)

    def w_of(ix, iy, wx, wy):
        inb = (0 <= ix) & (ix < H) & (0 <= iy) & (iy < W)
        return (wx * wy * inb).astype(np.float32)

    wx0, wx1 = ix1 - rx, rx - ix0
    wy0, wy1 = iy1 - ry, ry - iy0
    tbl = ForwardTable(
        H=H,
        W=W,
        npix_used=len(theta),
        idx00=_clip_flat_idx(ix0, iy0, H, W),
        idx10=_clip_flat_idx(ix1, iy0, H, W),
        idx01=_clip_flat_idx(ix0, iy1, H, W),
        idx11=_clip_flat_idx(ix1, iy1, H, W),
        w00=w_of(ix0, iy0, wx0, wy0),
        w10=w_of(ix1, iy0, wx1, wy0),
        w01=w_of(ix0, iy1, wx0, wy1),
        w11=w_of(ix1, iy1, wx1, wy1),
        nearest_idx=_clip_flat_idx(np.around(rx, 0).astype(int), np.around(ry, 0).astype(int), H, W),
        nearest_valid=(
            (0 <= np.around(rx, 0).astype(int)) & (np.around(rx, 0).astype(int) < H)
            & (0 <= np.around(ry, 0).astype(int)) & (np.around(ry, 0).astype(int) < W)
        ),
    )
    return tbl


def forward_table(cal_info, nside: int, base_pix: int, rotate_pole: bool) -> ForwardTable:
    key = json.dumps(
        {"intrinsic": cal_info["intrinsic"], "extrinsic": cal_info.get("extrinsic"),
         "name": cal_info.get("name")},
        sort_keys=True,
    )
    return _forward_table_cached(key, nside, base_pix, rotate_pole)


@dataclass(frozen=True)
class BackwardTable:
    """HP (C, npix_used) signal -> flat (C, Hout, Wout) image."""

    Hout: int
    Wout: int
    npix_used: int
    npix_full: int
    pix: np.ndarray  # (4, Hout*Wout) int64 HP neighbor indices (full-sphere)
    wgt: np.ndarray  # (4, Hout*Wout) float32
    nearest: np.ndarray  # (Hout*Wout,) int64

    def apply_image(self, hp_img, fill=255.0):
        C = hp_img.shape[0]
        full = np.full((C, self.npix_full), float(fill))
        full[:, : hp_img.shape[1]] = hp_img
        out = sum(full[:, self.pix[k]] * self.wgt[k] for k in range(4))
        return out.reshape(C, self.Hout, self.Wout)

    def apply_mask(self, hp_mask, s2_bkgd_class):
        full = np.full((self.npix_full,), s2_bkgd_class)
        full[: hp_mask.shape[0]] = hp_mask
        return full[self.nearest].reshape(self.Hout, self.Wout).astype(np.uint8)


@functools.lru_cache(maxsize=64)
def _backward_table_cached(cal_key, out_res_key, nside, base_pix, rotate_pole):
    cal_info = json.loads(cal_key)
    output_resolution = json.loads(out_res_key)
    if isinstance(output_resolution, list):
        output_resolution = tuple(output_resolution)
    W = cal_info["intrinsic"]["width"]
    H = cal_info["intrinsic"]["height"]
    u, v = fisheye.get_uv_from_hw(H, W, output_resolution)
    theta, phi = fisheye.project_img_points_to_s2(u, v, cal_info, rotate_pole)
    pix, wgt = hpx.get_interp_weights(nside, theta.reshape(-1), phi.reshape(-1), nest=True)
    nearest = np.take_along_axis(pix, np.argmax(wgt, axis=0)[None], axis=0)[0]
    return BackwardTable(
        Hout=u.shape[0],
        Wout=u.shape[1],
        npix_used=hpx.nside2npix(nside) * base_pix // 12,
        npix_full=hpx.nside2npix(nside),
        pix=pix,
        wgt=wgt.astype(np.float32),
        nearest=nearest,
    )


def backward_table(cal_info, output_resolution, nside: int, base_pix: int,
                   rotate_pole: bool) -> BackwardTable:
    key = json.dumps(
        {"intrinsic": cal_info["intrinsic"], "extrinsic": cal_info.get("extrinsic"),
         "name": cal_info.get("name")},
        sort_keys=True,
    )
    res_key = json.dumps(
        list(output_resolution) if isinstance(output_resolution, tuple) else output_resolution
    )
    return _backward_table_cached(key, res_key, nside, base_pix, rotate_pole)
