"""Dataset generation: project flat fisheye images/masks onto the HEALPix grid.

Mirrors reference ``heal_swin/data/segmentation/project_on_s2.py:344-444`` (CLI +
per-sample .npz output, byte-compatible with reference-generated datasets: keys
``hp_img`` (C, npix_used) uint8 and ``hp_mask`` (npix_used,) uint8), but uses the
precomputed per-calibration gather tables (projection/tables.py) instead of re-running
the polynomial projection per image — the geometry is computed once per calibration
cluster and each sample becomes two gathers.  The port's copy of
``heal_swin_tpu/data/segmentation/project_on_s2.py``, without its plot of the last
sample on the sphere (``--plot_last_on_s2`` raises: the port has no HEALPix plotting)."""

from __future__ import annotations

import argparse
import json
import os
from datetime import datetime

import numpy as np

from heal_swin_torch.data.segmentation import flat_datasets
from heal_swin_torch.projection import fisheye, tables
from heal_swin_torch.utils.utils import get_datasets_path


def save_metadata(args, save_dir, theta, phi):
    metadata = {
        "nside": args.nside,
        "base_pix": args.base_pix,
        "grid_type": "HEALPix",
        "created": datetime.now().strftime("%Y-%m-%d_%H:%M:%S"),
        "samples": args.samples,
        "part": args.part,
        "cam_pos": args.cam_pos,
    }
    with open(os.path.join(save_dir, "metadata.json"), "w") as f:
        json.dump(metadata, f)
    np.savez(os.path.join(save_dir, "grid.npz"), theta, phi)


def project_dataset_hp(dataset, args):
    if getattr(args, "plot_last_on_s2", False):
        raise NotImplementedError(
            "plot_last_on_s2: the port has no HEALPix plotting (heal_swin_tpu's "
            "utils/healpy_utils.py and utils/overlay.py are not ported)")
    img_save_dir = os.path.join(
        get_datasets_path() / args.woodscape_version, args.save_imgs_to
    )
    os.makedirs(img_save_dir, exist_ok=True)

    max_idx = len(dataset) if args.samples == -1 else args.samples
    theta, phi = fisheye.hp_grid_angles(args.nside, args.base_pix)
    save_metadata(args, img_save_dir, theta, phi)

    for idx in range(max_idx):
        img, mask, cal_info, file_name = dataset[idx]
        tbl = tables.forward_table(cal_info, args.nside, args.base_pix, args.rotate_pole)
        hp_img = tbl.apply_image(np.asarray(img, dtype=np.float64)).astype(np.uint8)
        hp_mask = tbl.apply_mask(np.asarray(mask), args.s2_bkgd_class).astype(np.uint8)
        np.savez(os.path.join(img_save_dir, file_name + ".npz"), hp_img=hp_img, hp_mask=hp_mask)


def add_args(parser):
    parser.add_argument("--cam_pos", type=str, choices=["fv", "rv", "mvr", "mvl"], default=None)
    parser.add_argument("--part", type=str, choices=["train", "val", "both"], default="both")
    parser.add_argument("--train_share", type=float, default=0)
    parser.add_argument("--samples", type=int, default=-1)
    parser.add_argument("--save_imgs_to", type=str, default="s2_images")
    parser.add_argument("--output_resolution", type=float, default=1)
    parser.add_argument("--plot_last_on_s2", action="store_true")
    parser.add_argument("--crop_green", action="store_true")
    parser.add_argument("--s2_bkgd_class", type=int, default=0)
    parser.add_argument("--rotate_pole", action="store_true")
    parser.add_argument("--nside", type=int, default=1)
    parser.add_argument("--base_pix", type=int, default=8)
    parser.add_argument("--woodscape_version", type=str)
    return parser


def main(args):
    parts = ["train", "val"] if args.part == "both" else [args.part]
    for part in parts:
        print(f"Projecting {part} dataset")
        dataset = flat_datasets.WoodscapeSemanticImagesCalibrationDataset(
            crop_green=args.crop_green,
            cam_pos=args.cam_pos,
            train_share=args.train_share,
            part=part,
            woodscape_version=args.woodscape_version,
        )
        project_dataset_hp(dataset, args)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    main(add_args(parser).parse_args())
    print("Done.")
