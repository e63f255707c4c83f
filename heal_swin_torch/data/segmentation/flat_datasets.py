"""Flat WoodScape segmentation datasets (reference
heal_swin/data/segmentation/flat_datasets.py), torchvision-free.

Images load as (C, H, W) uint8; masks as (H, W) uint8; calibrations as JSON dicts.
``size`` resizes images bilinearly and masks nearest (reference :103); ``crop_green``
center-crops to (960, 1280); ``padding`` is torchvision Pad([l, t, r, b]).  The port's
copy of ``heal_swin_tpu/data/segmentation/flat_datasets.py``: the flat datamodule, the
HEALPix path and ``project_on_s2`` use it."""

from __future__ import annotations

import json
import os

import numpy as np

from heal_swin_torch.data.woodscape_dataset import WoodscapeDataset
from heal_swin_torch.utils import image as I
from heal_swin_torch.utils.utils import get_datasets_path


class WoodscapeImagesDataset(WoodscapeDataset):
    def __init__(self, crop_green=False, *args, **kwargs):
        kwargs.pop("padding", None)
        super().__init__(*args, **kwargs)
        self.crop_green = crop_green

    def get_dir(self):
        return os.path.join(
            get_datasets_path() / self.woodscape_version, "rgb_images/rgb_images"
        )

    def __getitem__(self, idx):
        img = I.read_image(self.paths[idx])
        if self.crop_green:
            img = I.center_crop(img, (960, 1280))
        return img


class WoodscapeSemanticMasksDataset(WoodscapeDataset):
    def __init__(self, crop_green=False, *args, **kwargs):
        kwargs.pop("padding", None)
        super().__init__(*args, **kwargs)
        self.crop_green = crop_green
        self.names = [os.path.splitext(f)[0] for f in self.file_names]

    def get_dir(self):
        return os.path.join(
            get_datasets_path() / self.woodscape_version,
            "semantic_annotations/semantic_annotations/gtLabels",
        )

    def __getitem__(self, idx):
        mask = I.read_mask(self.paths[idx])
        if self.crop_green:
            mask = I.center_crop(mask, (960, 1280))
        return mask

    def get_item_by_name(self, name):
        return self[self.names.index(name)]


class WoodscapeCalibrationDataset(WoodscapeDataset):
    def get_extension(self):
        return ".json"

    def get_dir(self):
        return os.path.join(
            get_datasets_path() / self.woodscape_version, "calibration/calibration"
        )

    def __getitem__(self, idx):
        with open(self.paths[idx]) as f:
            cal_info = json.load(f)
        cal_info["file_name"] = str(self.file_names[idx])
        return cal_info


class WoodscapeSemanticImagesDataset:
    """Paired (img, mask) with resize/pad (reference :86-125)."""

    def __init__(self, crop_green=False, size=None, padding=(0, 0, 0, 0), *args, **kwargs):
        self.imgs_dataset = WoodscapeImagesDataset(crop_green, *args, **kwargs)
        self.masks_dataset = WoodscapeSemanticMasksDataset(crop_green, *args, **kwargs)
        masks_dir = self.masks_dataset.get_dir()
        self.masks_dataset.paths = [
            os.path.join(masks_dir, f) for f in self.imgs_dataset.file_names
        ]
        self.masks_dataset.update_paths()
        self.file_names = self.imgs_dataset.file_names
        self.size = size
        self.padding = padding

    def __len__(self):
        return len(self.imgs_dataset)

    def _transform(self, img, mask):
        if self.size is not None:
            img = I.resize_bilinear(img, self.size)
            mask = I.resize_nearest(mask, self.size)
        img = I.pad(img, list(self.padding))
        mask = I.pad(mask, list(self.padding))
        assert img.shape[-2] == mask.shape[-2]
        return img, mask

    def __getitem__(self, idx):
        img = self.imgs_dataset[idx]
        mask = self.masks_dataset[idx]
        assert (
            os.path.basename(self.imgs_dataset.file_names[idx])
            == os.path.basename(self.masks_dataset.file_names[idx])
        )
        return self._transform(img, mask)


class WoodscapeSemanticImagesCalibrationDataset(WoodscapeSemanticImagesDataset):
    """(img, mask, cal_info, name) (reference :128-186)."""

    def __init__(self, crop_green=False, size=None, padding=(0, 0, 0, 0), *args, **kwargs):
        super().__init__(crop_green, size, padding, *args, **kwargs)
        self.names = [os.path.splitext(f)[0] for f in self.file_names]
        self.cals_dataset = WoodscapeCalibrationDataset(*args, **kwargs)
        cals_dir = self.cals_dataset.get_dir()
        self.cals_dataset.paths = [
            os.path.join(cals_dir, f).replace(".png", ".json")
            for f in self.imgs_dataset.file_names
        ]
        self.cals_dataset.update_paths()

    def __getitem__(self, idx):
        img = self.imgs_dataset[idx]
        mask = self.masks_dataset[idx]
        cal_info = self.cals_dataset[idx]
        img, mask = self._transform(img, mask)
        return img, mask, cal_info, self.names[idx]

    def get_item_by_name(self, name):
        return self[self.names.index(name)]
