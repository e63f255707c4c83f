"""Windowing of nested-order HEALPix pixel sequences (counterpart of
``heal_swin_tpu/ops/windowing.py``).

Nested ordering stores every aligned run of ``window_size`` pixels as a spatially
contiguous block, so window partitioning is a pure reshape.
"""

from __future__ import annotations

import numpy as np
import torch


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, N, C) -> (B * N // ws, ws, C)."""
    B, N, C = x.shape
    return x.reshape(B * (N // window_size), window_size, C)


def window_reverse(windows: torch.Tensor, window_size: int, N: int) -> torch.Tensor:
    """(B * N // ws, ws, C) -> (B, N, C)."""
    B = windows.shape[0] // (N // window_size)
    return windows.reshape(B, N, windows.shape[-1])


def get_nest_win_idcs(window_size: int) -> np.ndarray:
    """sqrt(ws) x sqrt(ws) grid holding the nested (Z-order) index of each cell.

    Within a window the children of each 2x2 quad are ordered (x, y+1), (x, y),
    (x+1, y+1), (x+1, y); used to translate 2-D relative-position indices into nested
    order for the flat relative-position bias.
    """
    side = int(round(np.sqrt(window_size)))
    if side * side != window_size:
        raise ValueError(f"window_size must be a perfect square, got {window_size}")
    result = np.zeros((side, side), dtype=np.int64)

    def fill(idx, x, y, size):
        if size == 2:
            result[x, y + 1] = idx
            result[x, y] = idx + 1
            result[x + 1, y + 1] = idx + 2
            result[x + 1, y] = idx + 3
        else:
            h = size // 2
            q = size * size // 4
            fill(idx, x, y + h, h)
            fill(idx + q, x, y, h)
            fill(idx + 2 * q, x + h, y + h, h)
            fill(idx + 3 * q, x + h, y, h)

    fill(0, 0, 0, side)
    return result
