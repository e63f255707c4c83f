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


def save_image_grid(images, path, nrow=2):
    """Save a list of (3, H, W) uint8 images of one size as an RGB grid PNG, ``nrow``
    images a row (the JAX package's PIL grid, torchvision save_image's layout).  Images
    of differing sizes raise: the HEALPix writers hand over images of one size, and the
    flat writers that resize here come with the flat SWIN-UNet (ROADMAP queue 1 item
    5)."""
    imgs = [np.asarray(im, dtype=np.uint8) for im in images]
    H, W = imgs[0].shape[-2:]
    sizes = {im.shape[-2:] for im in imgs}
    if sizes != {(H, W)}:
        raise NotImplementedError(
            f"image grid of sizes {sorted(sizes)}: the port's grid takes images of one "
            "size; resizing in the grid comes with the flat writers (ROADMAP queue 1 "
            "item 5)")
    ncol = nrow
    nrows = -(-len(imgs) // ncol)
    grid = np.zeros((nrows * H, ncol * W, 3), dtype=np.uint8)
    for i, im in enumerate(imgs):
        r, c = divmod(i, ncol)
        grid[r * H:(r + 1) * H, c * W:(c + 1) * W] = im.transpose(1, 2, 0)
    png.write(path, grid)
