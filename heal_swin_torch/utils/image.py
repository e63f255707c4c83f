"""Image resizes with torch semantics, in numpy (the port's copy of the two resizes of
``heal_swin_tpu/utils/image.py``).

- resize_bilinear: ``F.interpolate(..., mode="bilinear", align_corners=False)``
  semantics (what torchvision Resize does on tensors, used for images in the reference)
- resize_nearest: legacy torch "nearest" (src = floor(dst * scale)), used for masks
  (reference flat_datasets.py:103, interpolation=0)
"""

from __future__ import annotations

import numpy as np


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
