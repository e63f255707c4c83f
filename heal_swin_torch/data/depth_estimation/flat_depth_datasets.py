"""SynWoodScape flat depth datasets
(reference heal_swin/data/depth_estimation/flat_depth_datasets.py).

Images: rgb_images/rgb_images/*.png; depth maps: depth_maps/raw_data/*.npy (float32
metric depths, 0 = invalid, 1000 = background/sky); calibration JSONs.  The mask
pipeline (0 -> inf, optional 1000 -> inf, transform, normalize) runs at load time.  The
port's copy of ``heal_swin_tpu/data/depth_estimation/flat_depth_datasets.py``."""

from __future__ import annotations

import json
import os

import numpy as np

from heal_swin_torch.data import normalize_depth_data as ndd
from heal_swin_torch.data.woodscape_dataset import WoodscapeDataset
from heal_swin_torch.utils import image as I
from heal_swin_torch.utils.utils import get_datasets_path


def change_extension(s, ext):
    return ".".join([s.split(".")[0], ext])


class WoodscapeDepthImagesDataset(WoodscapeDataset):
    def __init__(self, crop_green=False, size=None, *args, **kwargs):
        kwargs.pop("padding", None)
        super().__init__(*args, **kwargs)
        self.size = size

    def get_dir(self):
        return os.path.join(get_datasets_path() / self.woodscape_version, "rgb_images/rgb_images")

    def __getitem__(self, idx):
        img = I.read_image(self.paths[idx])
        if self.size is not None:
            img = I.resize_bilinear(img, self.size)
        return img


class WoodscapeDepthMaskDataset(WoodscapeDataset):
    def __init__(self, crop_green=False, *args, **kwargs):
        kwargs.pop("padding", None)
        kwargs.pop("size", None)
        super().__init__(*args, **kwargs)

    def get_dir(self):
        return os.path.join(get_datasets_path() / self.woodscape_version, "depth_maps/raw_data")

    def get_extension(self):
        return ".npy"

    def __getitem__(self, idx):
        return np.load(self.paths[idx]).astype(np.float32)


class WoodscapeDepthCalibrationDataset(WoodscapeDataset):
    def __init__(self, crop_green=False, *args, **kwargs):
        kwargs.pop("padding", None)
        kwargs.pop("size", None)
        super().__init__(*args, **kwargs)

    def get_extension(self):
        return ".json"

    def get_dir(self):
        return os.path.join(get_datasets_path() / self.woodscape_version, "calibration/calibration")

    def __getitem__(self, idx):
        with open(self.paths[idx]) as f:
            cal_info = json.load(f)
        cal_info["file_name"] = str(self.file_names[idx])
        return cal_info


def apply_depth_mask_pipeline(mask, mask_background, data_transform, normalize_data, stats):
    """0 -> inf, optional 1000 -> inf, transform, normalize
    (reference hp_depth_datasets.py:90-108 / flat_depth_datasets.py:130-147)."""
    mask = np.asarray(mask, dtype=np.float32).copy()
    mask[mask == 0] = np.inf
    if mask_background:
        mask[mask == 1000] = np.inf
    mask = np.asarray(ndd.mask_transform_fcn(data_transform)(mask))
    mask = np.asarray(ndd.normalize_data(mask, stats, normalize_data))
    return mask.astype(np.float32)


class WoodscapeDepthDataset:
    """(img, depth) pairs with the mask pipeline applied (reference :69-147).
    NOTE: flat loads apply the 0->inf mapping only via mask_background handling of 1000
    in the reference; zeros in raw maps are kept there — we match: 1000->inf only."""

    def __init__(self, size=None, crop_green=False, data_transform=None,
                 mask_background=False, normalize_data=None, interpolation_mode="nearest",
                 padding=(0, 0, 0, 0), *args, **kwargs):
        self.imgs_dataset = WoodscapeDepthImagesDataset(crop_green, None, *args, **kwargs)
        self.depth_masks_dataset = WoodscapeDepthMaskDataset(crop_green, *args, **kwargs)
        masks_dir = self.depth_masks_dataset.get_dir()
        self.depth_masks_dataset.paths = [
            os.path.join(masks_dir, change_extension(f, "npy"))
            for f in self.imgs_dataset.file_names
        ]
        self.depth_masks_dataset.update_paths()
        self.file_names = self.imgs_dataset.file_names
        self.size = size
        self.padding = padding
        self.interpolation_mode = interpolation_mode
        self.mask_background = mask_background
        self.data_transform = data_transform
        self.normalize_data = normalize_data
        self.data_stats = ndd.get_depth_data_stats(data_transform, mask_background)

    def __len__(self):
        return len(self.imgs_dataset)

    def _transform(self, img, mask):
        if self.size is not None:
            img = I.resize_bilinear(img, self.size)
            if self.interpolation_mode == "nearest":
                mask = I.resize_nearest(mask, self.size)
            else:
                mask = I.resize_bilinear(mask, self.size)
        img = I.pad(img, list(self.padding))
        mask = I.pad(mask, list(self.padding))
        return img, mask

    def __getitem__(self, idx):
        img = self.imgs_dataset[idx]
        mask = self.depth_masks_dataset[idx]
        img, mask = self._transform(img, mask)
        if self.mask_background:
            mask = mask.copy()
            mask[mask == 1000] = np.inf
        mask = np.asarray(ndd.mask_transform_fcn(self.data_transform)(mask))
        mask = np.asarray(ndd.normalize_data(mask, self.data_stats, self.normalize_data))
        # channels-last float image for the model
        return img.transpose(1, 2, 0).astype(np.float32), mask.astype(np.float32)


class WoodscapeDepthImagesCalibrationDataset:
    """(img (C,H,W), raw-transformed mask, cal_info, name) (reference :172-258)."""

    def __init__(self, size=None, interpolation_mode="nearest", data_transform=None,
                 mask_background=False, normalize_data=None, padding=(0, 0, 0, 0),
                 crop_green=False, *args, **kwargs):
        self.imgs_dataset = WoodscapeDepthImagesDataset(crop_green, None, *args, **kwargs)
        self.names = [os.path.splitext(f)[0] for f in self.imgs_dataset.file_names]
        self.file_names = self.imgs_dataset.file_names

        self.cals_dataset = WoodscapeDepthCalibrationDataset(crop_green, *args, **kwargs)
        cals_dir = self.cals_dataset.get_dir()
        self.cals_dataset.paths = [
            os.path.join(cals_dir, f).replace(".png", ".json")
            for f in self.imgs_dataset.file_names
        ]
        self.cals_dataset.update_paths()

        self.masks_dataset = WoodscapeDepthMaskDataset(crop_green, *args, **kwargs)
        masks_dir = self.masks_dataset.get_dir()
        self.masks_dataset.paths = [
            os.path.join(masks_dir, f.replace(".png", ".npy"))
            for f in self.imgs_dataset.file_names
        ]
        self.masks_dataset.update_paths()

        self.size = size
        self.padding = padding
        self.interpolation_mode = interpolation_mode
        self.mask_background = mask_background

    def __len__(self):
        return len(self.imgs_dataset)

    def __getitem__(self, idx):
        img = self.imgs_dataset[idx]
        mask = self.masks_dataset[idx]
        cal_info = self.cals_dataset[idx]
        if self.size is not None:
            img = I.resize_bilinear(img, self.size)
            mask = I.resize_nearest(mask, self.size)
        img = I.pad(img, list(self.padding))
        mask = I.pad(mask, list(self.padding))
        return img, mask, cal_info, self.names[idx]

    def get_item_by_name(self, name):
        return self[self.names.index(name)]
