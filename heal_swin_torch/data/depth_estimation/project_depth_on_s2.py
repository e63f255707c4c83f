"""Depth dataset generation: project SynWoodScape depth maps onto the HEALPix grid
(reference heal_swin/data/depth_estimation/project_depth_on_s2.py).

Differences from the segmentation variant: depth maps are float32 (.npy) sampled
nearest (background fill = s2_bkgd_class, default 0 -> mapped to inf at load time),
images bilinear float32; output .npz keys hp_img (3, npix) float32 / hp_mask (npix,)
float32.  The port's copy of ``heal_swin_tpu/data/depth_estimation/project_depth_on_s2.py``,
without its plot of the last sample on the sphere (``--plot_last_on_s2`` raises)."""

from __future__ import annotations

import argparse
import json
import os
from datetime import datetime

import numpy as np

from heal_swin_torch.data.depth_estimation import flat_depth_datasets
from heal_swin_torch.projection import fisheye, tables
from heal_swin_torch.utils.utils import get_datasets_path


def hp_depth_dataset_name(nside, base_pix, rotate_pole):
    """reference hp_depth_datasets.py:46-50."""
    name = f"hp_depth_images_nside={nside}_base_pix={base_pix}"
    name += "_rotate_pole" if rotate_pole else ""
    return name


def save_metadata(args, save_dir, theta, phi):
    metadata = {
        "grid_type": "HealPix",
        "created": datetime.now().strftime("%Y-%m-%d_%H:%M:%S"),
        "samples": args.samples,
        "part": args.part,
        "cam_pos": args.cam_pos,
    }
    with open(os.path.join(save_dir, "metadata.json"), "w") as f:
        json.dump(metadata, f)
    np.savez(os.path.join(save_dir, "grid.npz"), theta, phi)


def project_depth_dataset_hp(dataset, args):
    if getattr(args, "plot_last_on_s2", False):
        raise NotImplementedError(
            "plot_last_on_s2: the port has no HEALPix plotting (heal_swin_tpu's "
            "utils/healpy_utils.py is not ported)")
    save_dir = os.path.join(get_datasets_path() / args.woodscape_version, args.save_imgs_to)
    os.makedirs(save_dir, exist_ok=True)

    max_idx = len(dataset) if args.samples == -1 else args.samples
    theta, phi = fisheye.hp_grid_angles(args.nside, args.base_pix)
    save_metadata(args, save_dir, theta, phi)

    for idx in range(max_idx):
        img, mask, cal_info, file_name = dataset[idx]
        tbl = tables.forward_table(cal_info, args.nside, args.base_pix, args.rotate_pole)
        hp_img = tbl.apply_image(np.asarray(img, dtype=np.float64)).astype(np.float32)
        # depth sampled nearest, background fill then float (reference sample_mask)
        hp_mask = tbl.apply_mask(np.asarray(mask, dtype=np.float32), args.s2_bkgd_class)
        hp_mask = hp_mask.astype(np.float32)
        np.savez(os.path.join(save_dir, file_name + ".npz"), hp_img=hp_img, hp_mask=hp_mask)


def add_args(parser):
    parser.add_argument("--cam_pos", type=str, choices=["fv", "rv", "mvr", "mvl"], default=None)
    parser.add_argument("--part", type=str, choices=["train", "val", "both"], default="both")
    parser.add_argument("--train_share", type=float, default=0.8)
    parser.add_argument("--samples", type=int, default=-1)
    parser.add_argument("--save_imgs_to", type=str, default="depth_s2_images")
    parser.add_argument("--crop_green", action="store_true")
    parser.add_argument("--s2_bkgd_class", type=int, default=0)
    parser.add_argument("--rotate_pole", action="store_true")
    parser.add_argument("--nside", type=int, default=1)
    parser.add_argument("--grid", type=str, choices=["hp"], default="hp")
    parser.add_argument("--base_pix", type=int, default=8)
    parser.add_argument("--woodscape_version", type=str, default="synwoodscape")
    parser.add_argument("--plot_last_on_s2", action="store_true")
    return parser


def main(args):
    parts = ["train", "val"] if args.part == "both" else [args.part]
    for part in parts:
        print(f"Projecting {part} dataset")
        dataset = flat_depth_datasets.WoodscapeDepthImagesCalibrationDataset(
            crop_green=args.crop_green,
            cam_pos=args.cam_pos,
            train_share=args.train_share,
            part=part,
            woodscape_version=args.woodscape_version,
        )
        project_depth_dataset_hp(dataset, args)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    main(add_args(parser).parse_args())
    print("Done.")
