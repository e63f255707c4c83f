"""Fabricate a miniature WoodScape-layout dataset on disk for tests.

Creates the directory structure the real data layer expects (rgb_images, semantic
annotations, calibration JSONs with the quartic fisheye model, seg_annotation_info.json)
with small images so the full pipeline — file listing, projection dataset generation,
HP datamodule, back-projection writers — runs end-to-end without the real WoodScape
data (the synthetic-data fixture the reference lacks).  The port's copy of
``heal_swin_tpu/data/synthetic_woodscape.py``: the same arrays from the same seed,
written through the port's PNG codec (``utils/png.py``) instead of PIL."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from heal_swin_torch.utils import png

N_CLASSES = 4
CLASS_NAMES = ["void", "road", "vehicle", "sky"]
CLASS_COLORS = [[0, 0, 0], [90, 200, 90], [200, 90, 90], [90, 90, 220]]


def make_cal_info(name: str, W: int, H: int, k_scale: float):
    """Quartic fisheye calibration; rho(theta) monotone on [0, ~2.2 rad]."""
    return {
        "name": name,
        "intrinsic": {
            "aspect_ratio": 1.0,
            "cx_offset": 0.6,
            "cy_offset": -0.3,
            "width": W,
            "height": H,
            "poly_order": 4,
            "k1": 0.8 * k_scale,
            "k2": 0.05 * k_scale,
            "k3": -0.01 * k_scale,
            "k4": 0.002 * k_scale,
        },
        "extrinsic": {
            "quaternion": [0.0, 0.0, 0.0, 1.0],
            "translation": [0.0, 0.0, 1.2],
        },
    }


def generate(root, version="woodscape", n_per_cam=3, W=96, H=80, seed=0, with_depth=False):
    """Write a fake WoodScape tree under root/version; returns the version dir.
    ``with_depth=True`` also writes SynWoodScape-style depth maps
    (depth_maps/raw_data/*.npy, float32 metric depths, 1000 = background/sky)."""
    base = Path(root) / version
    img_dir = base / "rgb_images" / "rgb_images"
    mask_dir = base / "semantic_annotations" / "semantic_annotations" / "gtLabels"
    cal_dir = base / "calibration" / "calibration"
    depth_dir = base / "depth_maps" / "raw_data"
    for d in [img_dir, mask_dir, cal_dir] + ([depth_dir] if with_depth else []):
        d.mkdir(parents=True, exist_ok=True)

    with open(base / "semantic_annotations" / "seg_annotation_info.json", "w") as f:
        json.dump(
            {
                "class_names": CLASS_NAMES,
                "class_indexes": list(range(N_CLASSES)),
                "class_colors": CLASS_COLORS,
                "color_scheme": "RGB",
            },
            f,
        )

    rng = np.random.RandomState(seed)
    k_scale = min(W, H) / 3.5  # fisheye fills the frame
    idx = 0
    for cam in ["FV", "RV", "MVL", "MVR"]:
        cal = make_cal_info(cam, W, H, k_scale)
        for i in range(n_per_cam):
            name = f"{idx:05d}_{cam}"
            idx += 1
            yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
            r = np.sqrt((yy - H / 2) ** 2 + (xx - W / 2) ** 2)
            ang = np.arctan2(yy - H / 2, xx - W / 2)
            mask = (
                (r / max(H, W) * 6 + 1.5 * np.sin(2 * ang + i)).astype(int) % N_CLASSES
            ).astype(np.uint8)
            img = np.asarray(CLASS_COLORS, dtype=np.float64)[mask]
            img += rng.normal(0, 15, img.shape)
            img = np.clip(img, 0, 255).astype(np.uint8)
            png.write(img_dir / f"{name}.png", img)
            png.write(mask_dir / f"{name}.png", mask)
            with open(cal_dir / f"{name}.json", "w") as f:
                json.dump(cal, f)
            if with_depth:
                depth = (6.0 + 40.0 * r / max(H, W) + 3.0 * np.cos(ang + i)).astype(np.float32)
                depth[mask == 3] = 1000.0  # sky/background convention
                np.save(depth_dir / f"{name}.npy", depth)
    return base
