"""Mask/image overlays and image grids (the port's copy of
``heal_swin_tpu/utils/overlay.py``; reference utils.get_overlay /
overlay_from_seg_info, utils.py:70-106).  The grid is written with the port's PNG
codec (``utils/png.py``) where the JAX package uses PIL."""

from __future__ import annotations

import numpy as np

from heal_swin_torch.data.segmentation.hp_datamodule import get_seg_info
from heal_swin_torch.utils import png


def gen_mask_img(mask, class_indexes, class_colors) -> np.ndarray:
    """(H, W)-or-(N,) int mask -> (3, ...) uint8 colored mask."""
    mask = np.asarray(mask)
    out = np.zeros((3,) + mask.shape, dtype=np.int64)
    for value, color in zip(class_indexes, class_colors):
        out += (mask == value) * np.reshape(np.asarray(color), (3,) + (1,) * mask.ndim)
    return out.astype(np.uint8)


def overlay_from_seg_info(mask, img, seg_info, mask_opacity=0.4) -> np.ndarray:
    """(reference utils.py:87-99): blend colored mask over img where colored != 0."""
    mask_img = gen_mask_img(mask, seg_info["class_indexes"], seg_info["class_colors"])
    img = np.asarray(img, dtype=np.float64)
    overlay = (mask_img != 0) * ((1.0 - mask_opacity) * img + mask_opacity * mask_img)
    overlay = overlay + (mask_img == 0) * img
    return np.clip(overlay, 0, 255).astype(np.uint8)


def get_overlay(woodscape_version, mask, img, mask_opacity=0.4) -> np.ndarray:
    return overlay_from_seg_info(mask, img, get_seg_info(woodscape_version), mask_opacity)


_PRECISION_BITS = 22  # PIL's fixed-point coefficient bits for 8-bit images (32 - 8 - 2)


def _pil_bilinear_pass(x: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """One pass of PIL's 8-bit BILINEAR resample (``ImagingResample``) along ``axis`` of
    a uint8 array: the triangle filter over a support widened by the downscale, its
    weights normalized per output pixel and rounded to 22-bit fixed point, each output
    rounded and clipped to 0..255."""
    n_in = x.shape[axis]
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = filterscale
    out_shape = list(x.shape)
    out_shape[axis] = n_out
    out = np.empty(out_shape, dtype=np.uint8)
    xm = np.moveaxis(x, axis, 0).astype(np.int64)
    om = np.moveaxis(out, axis, 0)
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        t = np.abs((np.arange(lo, hi) - center + 0.5) / filterscale)
        k = np.where(t < 1.0, 1.0 - t, 0.0)
        k = k / k.sum() if k.sum() != 0.0 else k
        kk = np.trunc(k * (1 << _PRECISION_BITS) + np.where(k < 0, -0.5, 0.5)).astype(np.int64)
        acc = (1 << (_PRECISION_BITS - 1)) + np.tensordot(kk, xm[lo:hi], axes=(0, 0))
        om[i] = np.clip(acc >> _PRECISION_BITS, 0, 255)
    return out


def resize_bilinear_pil(img: np.ndarray, size) -> np.ndarray:
    """A (3, H, W) uint8 image resized to ``size`` (h, w) as PIL's ``Image.resize(..,
    BILINEAR)`` does it: horizontal pass first, then vertical, each in 8-bit fixed point,
    so the result is PIL's bit for bit."""
    h, w = size
    x = np.asarray(img, dtype=np.uint8)
    if x.shape[-1] != w:
        x = _pil_bilinear_pass(x, w, axis=2)
    if x.shape[-2] != h:
        x = _pil_bilinear_pass(x, h, axis=1)
    return x


def save_image_grid(images, path, nrow=2):
    """Save a list of (3, H, W) uint8 images as an RGB grid PNG, ``nrow`` images a row
    (the JAX package's PIL grid, torchvision save_image's layout): each image of another
    size is first resized to the first image's as PIL's bilinear resize does it
    (``resize_bilinear_pil``)."""
    imgs = [np.asarray(im, dtype=np.uint8) for im in images]
    H, W = imgs[0].shape[-2:]
    imgs = [im if im.shape[-2:] == (H, W) else resize_bilinear_pil(im, (H, W)) for im in imgs]
    ncol = nrow
    nrows = -(-len(imgs) // ncol)
    grid = np.zeros((nrows * H, ncol * W, 3), dtype=np.uint8)
    for i, im in enumerate(imgs):
        r, c = divmod(i, ncol)
        grid[r * H:(r + 1) * H, c * W:(c + 1) * W] = im.transpose(1, 2, 0)
    png.write(path, grid)
