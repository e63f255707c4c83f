"""Depth point clouds and the HEALPix footprint cutout, numpy (the port's copy of the
parts of ``heal_swin_tpu/utils/depth_utils.py`` the Chamfer evaluation uses;
reference ``heal_swin/utils/depth_utils.py``)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from heal_swin_torch.projection import fisheye
from heal_swin_torch.utils import image as I


def get_foreground_mask(data: np.ndarray, background_val=float("nan")) -> np.ndarray:
    """Boolean foreground mask (reference depth_utils.py:609-626)."""
    if isinstance(background_val, (tuple, list)):
        masks = [get_foreground_mask(data, b) for b in background_val]
        return np.all(np.stack(masks), axis=0)
    if isinstance(background_val, float) and np.isnan(background_val):
        return ~np.isnan(data)
    if isinstance(background_val, float) and np.isinf(background_val):
        return ~np.isinf(data)
    return data != background_val


def get_ray_angles(data, cal_info: Dict, nside=8, hp_data=False, base_pix=8,
                   rotate_pole=False) -> Tuple[np.ndarray, np.ndarray]:
    """(theta, phi) per element of a flat (..., H, W) or HP (..., npix) map
    (reference depth_utils.py:399-430)."""
    if not hp_data:
        H, W = data.shape[-2], data.shape[-1]
        u, v = fisheye.get_uv_from_hw(H, W, (H, W))
        return fisheye.project_img_points_to_s2(u, v, cal_info, rotate_pole, used_size=(H, W))
    return fisheye.hp_grid_angles(nside, base_pix)


def create_point_cloud_from_depth_mask(
    data: np.ndarray,
    cal_info: Dict,
    nside: int = 256,
    hp_data: bool = False,
    base_pix: int = 8,
    rotate_pole: bool = False,
    background_val=float("nan"),
) -> Tuple[np.ndarray, np.ndarray]:
    """data: (N, H, W) flat or (N, npix) HP depth maps -> ((N, P, 3) point cloud,
    (N, P) foreground mask); points = depth * ray direction, rotated by the extrinsic
    quaternion (reference depth_utils.py:465-539)."""
    data = np.asarray(data, dtype=np.float64)
    fg = get_foreground_mask(data, background_val)
    theta, phi = get_ray_angles(data, cal_info, nside, hp_data, base_pix, rotate_pole)
    x = np.sin(theta) * np.cos(phi)
    y = np.sin(theta) * np.sin(phi)
    z = np.cos(theta)
    dirs = np.stack([x, y, z], axis=-1)  # (..., 3)
    pc = data[..., None] * dirs  # (N, ..., 3)
    pc = pc.reshape(data.shape[0], -1, 3)
    fg = fg.reshape(data.shape[0], -1)
    rot = fisheye._quat_to_matrix(cal_info["extrinsic"]["quaternion"])
    pc = pc @ rot.T
    return pc, fg


def mask_flat_with_hp_cutout(
    flat_data: np.ndarray,
    cal_info: Dict,
    base_pix: int = 8,
    nside: int = 256,
    rotate_pole: bool = False,
    masking_val=float("nan"),
) -> np.ndarray:
    """Set flat pixels outside the HP footprint to masking_val by round-tripping an
    all-ones mask through the HP grid (reference depth_utils.py:542-606)."""
    data = np.array(flat_data, dtype=np.float64)
    squeeze = data.ndim == 2
    if squeeze:
        data = data[None]

    theta, phi = fisheye.hp_grid_angles(nside, base_pix)
    u, v = fisheye.project_s2_points_to_img(theta, phi, cal_info, rotate_pole)
    ones = np.ones_like(data)
    hp_ones = fisheye.sample_bilinear(ones, v, u).astype(np.float32).squeeze()
    back = fisheye.project_hp_depth_back(
        hp_ones, cal_info, 1.0, rotate_pole, nside, base_pix, s2_bkgd_class=-1
    )
    mask = back == -1  # (1, H, W)
    if mask.shape[-2:] != data.shape[-2:]:
        mask = I.resize_nearest(mask.astype(np.uint8), data.shape[-2:]).astype(bool)
    data[np.broadcast_to(mask, data.shape)] = masking_val
    return data[0] if squeeze else data
