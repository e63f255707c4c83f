"""Image ops with torch semantics, in numpy (the port's copy of
``heal_swin_tpu/utils/image.py``, decoding through the port's own PNG codec,
``utils/png.py``, where the JAX package uses OpenCV or PIL).

- read_image: PNG -> (C, H, W) uint8 RGB, like torchvision.io.read_image
- read_mask: label PNG -> (H, W) uint8 (palette images: the palette indices, PIL's raw
  array), (H, W, C) for gray + alpha / RGB / RGBA
- resize_bilinear: ``F.interpolate(..., mode="bilinear", align_corners=False)``
  semantics (what torchvision Resize does on tensors, used for images in the reference)
- resize_nearest: legacy torch "nearest" (src = floor(dst * scale)), used for masks
  (reference flat_datasets.py:103, interpolation=0)
- center_crop / pad: torchvision CenterCrop / Pad([l, t, r, b]) semantics
"""

from __future__ import annotations

import numpy as np

from heal_swin_torch.utils import png


def read_image(path) -> np.ndarray:
    """PNG -> (C, H, W) uint8 RGB: palette images through their palette, gray ones
    repeated over the three channels, alpha dropped.  A view of the decoded (H, W, 3)
    samples, not a copy."""
    img = png.read(path)
    s = img.samples
    if img.color_type == 3:
        if img.palette is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        rgb = img.palette[s]
    elif img.color_type in (0, 4):
        gray = s if s.ndim == 2 else s[..., 0]
        rgb = np.repeat(gray[..., None], 3, axis=-1)
    else:
        rgb = s[..., :3]
    return rgb.transpose(2, 0, 1)


def read_mask(path) -> np.ndarray:
    """Label PNG -> its raw samples: (H, W) for gray and for palette images (the
    palette indices, the class ids), (H, W, C) otherwise."""
    return png.read(path).samples


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """img: (..., H, W) float/uint8 -> (..., h, w); align_corners=False, no antialias."""
    h_out, w_out = size
    *lead, H, W = img.shape
    x = img.reshape(-1, H, W).astype(np.float64)

    def coords(n_out, n_in):
        scale = n_in / n_out
        c = (np.arange(n_out) + 0.5) * scale - 0.5
        c0 = np.floor(c).astype(int)
        frac = c - c0
        c0c = np.clip(c0, 0, n_in - 1)
        c1c = np.clip(c0 + 1, 0, n_in - 1)
        return c0c, c1c, frac

    r0, r1, fr = coords(h_out, H)
    c0, c1, fc = coords(w_out, W)
    top = x[:, r0][:, :, c0] * (1 - fc) + x[:, r0][:, :, c1] * fc
    bot = x[:, r1][:, :, c0] * (1 - fc) + x[:, r1][:, :, c1] * fc
    out = top * (1 - fr)[None, :, None] + bot * fr[None, :, None]
    out = out.reshape(*lead, h_out, w_out)
    if np.issubdtype(img.dtype, np.integer):
        out = np.clip(np.round(out), 0, 255)
    return out.astype(img.dtype)


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """Legacy torch 'nearest': src index = floor(dst * in/out)."""
    h_out, w_out = size
    *lead, H, W = img.shape
    rows = np.minimum((np.arange(h_out) * (H / h_out)).astype(int), H - 1)
    cols = np.minimum((np.arange(w_out) * (W / w_out)).astype(int), W - 1)
    return img[..., rows[:, None], cols[None, :]]


def center_crop(img: np.ndarray, size) -> np.ndarray:
    h, w = size
    H, W = img.shape[-2:]
    top = (H - h) // 2
    left = (W - w) // 2
    return img[..., top : top + h, left : left + w]


def pad(img: np.ndarray, padding) -> np.ndarray:
    """torchvision Pad([l, t, r, b]) (or int) with zeros."""
    if isinstance(padding, int):
        padding = [padding] * 4
    left, top, right, bottom = padding
    if not any(padding):
        return img
    spec = [(0, 0)] * (img.ndim - 2) + [(top, bottom), (left, right)]
    return np.pad(img, spec)
