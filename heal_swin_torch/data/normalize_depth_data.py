"""Depth data statistics, transforms and normalization (counterpart of
``heal_swin_tpu/data/normalize_depth_data.py``).

The stats are the SynWoodScape dataset statistics the JAX package hardcodes, per
transform (None / log / inv) and masked or not; the constants are copied because the
JAX module imports ``jax.numpy`` when it loads.  The transforms are functional torch
code (no in-place writes): ``inverse_mask`` sends inf to 0, values below 1e-3 to inf
and the rest to 1/x, so it is its own inverse.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


class DataStats:
    def __init__(self, name, max, min, mean, std, total_pixels=None, total_background=None):
        self.name = name
        self.max = max
        self.min = min
        self.mean = mean
        self.std = std
        self.total_pixels = total_pixels
        self.total_background = total_background

    def __str__(self):
        s = f"Data stats object:\nName: {self.name}\n"
        s += f"max: {self.max:.4f}\nmin: {self.min:.4f}\nmean: {self.mean:.4f}\nstd: {self.std:.4f}"
        if self.total_pixels is not None:
            s += f"\ntotal_pixels: {self.total_pixels:.4f}"
        if self.total_background is not None:
            s += f"\ntotal_background: {self.total_background:.4f}"
        return s


class MaskedDepthDataStatistics(DataStats):
    def __init__(self):
        super().__init__("Masked depth data stats", 999.94287109375, 0.16296708583831787,
                         13.654291032986958, 29.58008801108711, total_pixels=2876849543)


class DepthDataStatistics(DataStats):
    def __init__(self):
        super().__init__("Depth data stats", 999.94287109375, 0.16296708583831787,
                         53.27547067117465, 195.83201099547819,
                         total_pixels=2997248000, total_background=120398457)


class LogDepthDataStatistics(DataStats):
    def __init__(self):
        super().__init__("Log depth data stats", 6.907755374908447, -1.8142070770263672,
                         1.4544509182015166, 2.0786484162088192)


class MaskedLogDepthDataStatistics(DataStats):
    def __init__(self):
        super().__init__("Masked log depth data stats", 6.907698154449463, -1.8142070770263672,
                         1.226225759977343, 1.7902344298584563)


class InvDepthDataStatistics(DataStats):
    def __init__(self):
        super().__init__("Inv depth data stats", 6.136208534240723, 0.001,
                         0.9910007833745446, 1.449026079271616,
                         total_pixels=2997248000, total_background=120398457)


class MaskedInvDepthDataStatistics(DataStats):
    def __init__(self):
        super().__init__("Masked inv depth data stats", 6.136208534240723, 0.0010000570910051465,
                         1.0324331088958505, 1.4645187100900352,
                         total_pixels=2997248000, total_background=120398457)


def get_depth_data_stats(data_transform: Union[None, str] = None,
                         mask_background: bool = False) -> DataStats:
    stats = {
        False: {"log": LogDepthDataStatistics, "inv": InvDepthDataStatistics,
                "None": DepthDataStatistics},
        True: {"log": MaskedLogDepthDataStatistics, "inv": MaskedInvDepthDataStatistics,
               "None": MaskedDepthDataStatistics},
    }
    return stats[mask_background]["None" if data_transform is None else data_transform]()


def inverse_mask(x):
    """inf -> 0; values < 1e-3 -> inf; else 1/x.  Self-inverse."""
    x = torch.as_tensor(x)
    is_inf = torch.isinf(x)
    small = (x < 1e-3) & ~is_inf
    rest = ~(is_inf | small)
    safe = torch.where(rest, x, torch.ones_like(x))
    return torch.where(is_inf, torch.zeros_like(x),
                       torch.where(small, torch.full_like(x, float("inf")), 1.0 / safe))


def log_mask(x):
    return torch.log(torch.as_tensor(x))


def exp_mask(x):
    return torch.exp(torch.as_tensor(x))


def _id(x):
    return x


def mask_transform_fcn(transform_type: Optional[str]):
    return {"log": log_mask, "inv": inverse_mask, "None": _id, None: _id}[transform_type]


def reverse_mask_transform_fcn(transform_type: Optional[str]):
    return {"log": exp_mask, "inv": inverse_mask, "None": _id, None: _id}[transform_type]


def _divisor(data, value):
    """``value`` as a 0-d tensor of ``data``'s dtype on its device when ``data`` is a
    tensor: the division by it is then IEEE division on a GPU too (a Python scalar
    divisor there becomes a product with its reciprocal, an ulp off the host's
    quotient)."""
    if isinstance(data, torch.Tensor):
        return torch.tensor(value, dtype=data.dtype, device=data.device)
    return value


def normalize_data(data, data_stats: DataStats, norm_type: Optional[str] = None):
    if norm_type == "standardize":
        return (data - data_stats.mean) / _divisor(data, data_stats.std)
    if norm_type == "min-max":
        return (data - data_stats.min) / _divisor(data, data_stats.max - data_stats.min)
    return data


def unnormalize_data(data, data_stats: DataStats, norm_type: Optional[str] = None):
    if norm_type == "standardize":
        return data * data_stats.std + data_stats.mean
    if norm_type == "min-max":
        return data * (data_stats.max - data_stats.min) + data_stats.min
    return data


def transform_and_normalize(data, normalization, data_stats, data_transform):
    return normalize_data(mask_transform_fcn(data_transform)(data), data_stats, normalization)


def unnormalize_and_retransform(data, normalization, data_stats, data_transform):
    return reverse_mask_transform_fcn(data_transform)(
        unnormalize_data(data, data_stats, normalization))
