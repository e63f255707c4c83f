"""Fisheye camera model <-> sphere <-> HEALPix geometry, numpy (the port's copy of the
parts of ``heal_swin_tpu/projection/fisheye.py`` the depth evaluation uses).

The reference's ``heal_swin/data/segmentation/project_on_s2.py`` quartic model:

- forward: sphere angles -> ``rho = sum_i k_i theta^i``, ``u = rho cos(phi) + cx + W/2
  - 0.5``, ``v = rho sin(phi) * ar + cy + H/2 - 0.5`` (reference :139-153);
- inverse: image grid -> rho -> theta by root finding of the polynomial on the
  reference's 100-knot rho grid and linear interpolation between the knots
  (reference :187-219), with brentq in place of Newton-Krylov: the same root of the
  same monotone polynomial;
- optional ``rotate_pole`` aligns the grid pole with the optical axis through the
  extrinsic quaternion (reference :109-136).

Image conventions as the reference: origin upper-left, u along width, v along
height, images (C, H, W).  Both projections keep small lru caches keyed by their
inputs' bytes, and the HP grid's angles are cached: the writers project the same
grids sample after sample.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
from scipy import optimize

from heal_swin_torch.ops import healpix as hpx


def sample_within_bounds(signal, x, y, bounds, background_value):
    xmin, xmax, ymin, ymax = bounds
    idxs = (xmin <= x) & (x < xmax) & (ymin <= y) & (y < ymax)
    if signal.ndim > 2:
        sample = np.full((signal.shape[0], *x.shape), background_value, dtype=np.float64)
        sample[:, idxs] = signal[:, x[idxs], y[idxs]]
    else:
        sample = np.full(x.shape, background_value, dtype=np.float64)
        sample[idxs] = signal[x[idxs], y[idxs]]
    return sample


def sample_bilinear(signal, rx, ry):
    """signal: (C, H, W); rx indexes dim 1 (v), ry dim 2 (u); OOB contributes 0."""
    dim_x, dim_y = signal.shape[1], signal.shape[2]
    ix0 = np.floor(rx).astype(int)
    iy0 = np.floor(ry).astype(int)
    ix1 = np.ceil(rx).astype(int)
    iy1 = np.ceil(ry).astype(int)
    bounds = (0, dim_x, 0, dim_y)
    s00 = sample_within_bounds(signal, ix0, iy0, bounds, 0)
    s10 = sample_within_bounds(signal, ix1, iy0, bounds, 0)
    s01 = sample_within_bounds(signal, ix0, iy1, bounds, 0)
    s11 = sample_within_bounds(signal, ix1, iy1, bounds, 0)
    fx1 = (ix1 - rx) * s00 + (rx - ix0) * s10
    fx2 = (ix1 - rx) * s01 + (rx - ix0) * s11
    return (iy1 - ry) * fx1 + (ry - iy0) * fx2


_EXT_REF = {"FV": [1, 0, 0], "RV": [-1, 0, 0], "MVL": [0, 1, 0], "MVR": [0, -1, 0]}


def _quat_to_matrix(q):
    """Rotation matrix from quaternion (x, y, z, w) (scipy convention)."""
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 2.0 / n
    return np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
            [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
            [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
        ]
    )


def _euler_yz_matrix(theta_ref, phi_ref):
    """scipy Rotation.from_euler("yz", [a, b]) == Rz(b) @ Ry(a) (extrinsic)."""
    ca, sa = np.cos(theta_ref), np.sin(theta_ref)
    cb, sb = np.cos(phi_ref), np.sin(phi_ref)
    ry = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])
    rz = np.array([[cb, -sb, 0], [sb, cb, 0], [0, 0, 1]])
    return rz @ ry


def rot_grid(theta, phi, cal_info, inv=False):
    r_ext = _quat_to_matrix(cal_info["extrinsic"]["quaternion"])
    ext_ref = np.asarray(_EXT_REF[cal_info["name"]], dtype=np.float64)
    int_ref = r_ext.T @ ext_ref  # Rotation.inv().apply
    phi_ref = np.arctan2(int_ref[1], int_ref[0])
    theta_ref = np.arccos(np.clip(int_ref[2], -1, 1))
    r_grid = _euler_yz_matrix(theta_ref, phi_ref)
    if inv:
        r_grid = r_grid.T
    x = (np.cos(phi) * np.sin(theta)).reshape(-1)
    y = (np.sin(phi) * np.sin(theta)).reshape(-1)
    z = np.cos(theta).reshape(-1)
    xyz = np.stack((x, y, z), axis=-1) @ r_grid.T
    phi_rot = np.arctan2(xyz[:, 1], xyz[:, 0]).reshape(phi.shape)
    theta_rot = np.arccos(np.clip(xyz[:, 2], -1, 1)).reshape(theta.shape)
    return theta_rot, phi_rot


def _intrinsics(cal_info) -> Tuple:
    i = cal_info["intrinsic"]
    ks = tuple(i["k" + str(o)] for o in range(1, i["poly_order"] + 1))
    return (
        i["aspect_ratio"], i["cx_offset"], i["cy_offset"],
        int(i["width"]), int(i["height"]), ks,
    )


@functools.lru_cache(maxsize=23)
def _project_s2_points_to_img_cached(theta_b, phi_b, shape, ar, cx, cy, width, height, ks):
    theta = np.frombuffer(theta_b).reshape(shape)
    phi = np.frombuffer(phi_b).reshape(shape)
    rho = np.zeros_like(theta)
    for order, k in enumerate(ks, start=1):
        rho = rho + k * theta**order
    u = rho * np.cos(phi) + cx + width / 2 - 0.5
    v = rho * np.sin(phi) * ar + cy + height / 2 - 0.5
    return u, v


def project_s2_points_to_img(theta, phi, cal_info, rotate_pole, used_size=None):
    """(theta, phi) on the sphere -> float pixel coordinates (u, v).

    ``used_size=(H, W)`` replaces the calibration dims in the center offset — the
    depth variant's semantics (reference project_depth_on_s2.py:140-173)."""
    if rotate_pole:
        theta, phi = rot_grid(theta, phi, cal_info, inv=False)
    ar, cx, cy, width, height, ks = _intrinsics(cal_info)
    if used_size is not None:
        height, width = int(used_size[0]), int(used_size[1])
    theta = np.ascontiguousarray(theta, dtype=np.float64)
    phi = np.ascontiguousarray(phi, dtype=np.float64)
    return _project_s2_points_to_img_cached(
        theta.tobytes(), phi.tobytes(), theta.shape, ar, cx, cy, width, height, ks
    )


def _poly(ks):
    def f(theta):
        rho = 0.0
        for order, k in enumerate(ks, start=1):
            rho = rho + k * theta**order
        return rho

    return f


@functools.lru_cache(maxsize=23)
def _project_img_points_to_s2_cached(u_b, v_b, shape, ar, cx, cy, width, height, ks,
                                     def_width=None, def_height=None):
    u = np.frombuffer(u_b).reshape(shape).copy()
    v = np.frombuffer(v_b).reshape(shape).copy()
    if def_width is not None:  # depth used_size semantics: rescale to original dims
        u = u * def_width / width
        v = v * def_height / height
        width, height = def_width, def_height
    u = u - cx - width / 2 + 0.5
    v = (v - cy - height / 2 + 0.5) / ar
    rho = np.sqrt(u**2 + v**2)
    phi = np.arctan2(v, u)
    phi[phi < 0] = 2 * np.pi + phi[phi < 0]

    poly = _poly(ks)
    # the reference's interpolation knots (:214-217); bisection finds the same root
    # of the same monotone polynomial as its Newton-Krylov
    rho_samples = np.linspace(0, rho.max(), 100)
    hi = np.pi
    while poly(hi) < rho_samples[-1]:  # ensure bracket
        hi *= 1.5
    theta_samples = [
        optimize.brentq(lambda t, r=r: poly(t) - r, 0.0, hi, xtol=1e-12) for r in rho_samples
    ]
    theta = np.interp(rho, rho_samples, np.asarray(theta_samples))
    return theta, phi


def project_img_points_to_s2(u, v, cal_info, rotate_pole, used_size=None):
    """Float pixel coordinates -> (theta, phi) on the sphere.

    ``used_size=(H, W)``: the coordinates live on a resized image; rescale to the
    calibration's native dims first (reference project_depth_on_s2.py:176-258)."""
    ar, cx, cy, width, height, ks = _intrinsics(cal_info)
    u = np.ascontiguousarray(u, dtype=np.float64)
    v = np.ascontiguousarray(v, dtype=np.float64)
    if used_size is None:
        theta, phi = _project_img_points_to_s2_cached(
            u.tobytes(), v.tobytes(), u.shape, ar, cx, cy, width, height, ks
        )
    else:
        theta, phi = _project_img_points_to_s2_cached(
            u.tobytes(), v.tobytes(), u.shape, ar, cx, cy,
            int(used_size[1]), int(used_size[0]), ks, width, height,
        )
    if rotate_pole:
        theta, phi = rot_grid(theta, phi, cal_info, inv=True)
    return theta, phi


def get_uv_from_hw(height, width, output_resolution):
    """Pixel coordinate meshgrid at the requested output resolution (reference :266-287)."""
    if isinstance(output_resolution, float):
        height_res = int(height * output_resolution)
        width_res = int(width * output_resolution)
    elif isinstance(output_resolution, int):
        if width <= height:
            width_res = output_resolution
            height_res = int(height * output_resolution) // width_res
        else:
            height_res = output_resolution
            width_res = int(width * output_resolution) // height_res
    else:
        height_res, width_res = output_resolution[0], output_resolution[1]
    u_range = np.linspace(0, width - 1, width_res)
    v_range = np.linspace(0, height - 1, height_res)
    return np.meshgrid(u_range, v_range, indexing="xy")


def project_hp_depth_back(
    hp_mask, cal_info, output_resolution, rotate_pole, nside, base_pix, s2_bkgd_class
):
    """Float (depth) HP map -> flat map via bilinear HP interpolation, background fill
    (reference project_depth_hp_mask_back, project_depth_on_s2.py:370-386).
    Returns shape (1, Hout, Wout)."""
    width = cal_info["intrinsic"]["width"]
    height = cal_info["intrinsic"]["height"]
    u, v = get_uv_from_hw(height, width, output_resolution)
    theta, phi = project_img_points_to_s2(u, v, cal_info, rotate_pole)

    full = np.full((hp_mask.shape[0] * 12 // base_pix,), s2_bkgd_class, dtype=np.float32)
    full[: hp_mask.shape[0]] = hp_mask
    return np.array([hpx.get_interp_val(full, theta, phi, nest=True)])


@functools.lru_cache(maxsize=4)
def hp_grid_angles(nside: int, base_pix: int):
    """(theta, phi) of the first base_pix/12 nested pixels (reference :351-357),
    cached and read-only: every HP point cloud and cutout of an evaluation asks for
    the same grid."""
    npix = hpx.nside2npix(nside)
    theta, phi = hpx.pix2ang(nside, np.arange(npix), nest=True)
    half = npix * base_pix // 12
    theta, phi = theta[:half], phi[:half]
    theta.flags.writeable = phi.flags.writeable = False
    return theta, phi
