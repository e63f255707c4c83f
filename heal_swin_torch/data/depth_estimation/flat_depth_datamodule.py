"""Flat depth datamodule (the port's copy of
``heal_swin_tpu/data/depth_estimation/flat_depth_datamodule.py``; reference
heal_swin/data/depth_estimation/flat_depth_datamodule.py).  Samples are channels-last
float32 (H, W, 3) images and network-space (H, W) depth targets; predict batches also
carry the originals, the calibration and the matching HP sample for the writers.  The
base and best/worst writers draw with matplotlib and raise (ROADMAP queue 1 item 8)."""

from __future__ import annotations

import numpy as np

from heal_swin_torch.data.depth_estimation import flat_depth_datasets
from heal_swin_torch.data.loading import (
    DataLoader,
    default_collate,
    pred_overfit_indices,
)
from heal_swin_torch.data.depth_estimation.hp_depth_datamodule import (
    WoodscapeHPDepthImagesDataset,
)
from heal_swin_torch.data.segmentation.hp_datamodule import _samples_to_train_share


class WoodscapeDepthImagesPredictDataset:
    """Resized pair + originals + calibration (reference flat_depth_datasets.py:260-384)."""

    def __init__(self, crop_green=False, cam_pos=None, samples=40, base_train_share=0.8,
                 part="val", size=None, padding=(0, 0, 0, 0), shuffle_train_val_split=True,
                 data_transform=None, normalize_data=None, mask_background=False,
                 nside=256, base_pix=8, rotate_pole=False,
                 woodscape_version="synwoodscape"):
        kwargs = dict(
            crop_green=crop_green, cam_pos=cam_pos,
            shuffle_train_val_split=shuffle_train_val_split,
            woodscape_version=woodscape_version,
        )
        train_share = _samples_to_train_share(
            samples, part, base_train_share,
            lambda: len(
                flat_depth_datasets.WoodscapeDepthDataset(
                    part="train", train_share=1.0, size=size, padding=padding,
                    data_transform=data_transform, normalize_data=normalize_data,
                    mask_background=mask_background, **kwargs,
                )
            ),
        )
        if isinstance(samples, int) and samples == -1:
            part = "train"

        self.transf_dataset = flat_depth_datasets.WoodscapeDepthDataset(
            part=part, train_share=train_share, size=size, padding=padding,
            data_transform=data_transform, normalize_data=normalize_data,
            mask_background=mask_background, **kwargs,
        )
        self.cal_dataset = flat_depth_datasets.WoodscapeDepthImagesCalibrationDataset(
            part=part, train_share=train_share, size=None,
            data_transform=data_transform, normalize_data=normalize_data,
            mask_background=mask_background, **kwargs,
        )
        # matching HP depth sample joined by name (reference flat_depth_datasets.py:333-346)
        self.hp_dataset = WoodscapeHPDepthImagesDataset(
            crop_green=crop_green, cam_pos=cam_pos, train_share=train_share, part=part,
            nside=nside, base_pix=base_pix, rotate_pole=rotate_pole,
            data_transform=data_transform, normalize_data=normalize_data,
            mask_background=mask_background, woodscape_version=woodscape_version,
        )

    def __len__(self):
        return len(self.cal_dataset)

    @property
    def names(self):
        """Sample names by index (writers resolve ranked names in O(1))."""
        return self.cal_dataset.names

    def __getitem__(self, idx):
        transf_img, transf_mask = self.transf_dataset[idx]
        img, mask, cal_info, name = self.cal_dataset[idx]
        hp_img_cl, hp_mask = self.hp_dataset.get_item_by_name(name)
        return {
            "s2_imgs": transf_img,  # (H, W, 3) model input
            "s2_masks": transf_mask,  # network-space target
            "imgs": img,
            "masks": mask,  # raw metric depths
            "hp_imgs": hp_img_cl,  # (npix, 3)
            "hp_masks": hp_mask,  # network-space HP depth target
            "cal_infos": cal_info,
            "names": name,
        }


class WoodscapeFlatDepthDataModule:
    """reference flat_depth_datamodule.py; constructed from WoodscapeDepthFlatConfig."""

    def __init__(self, config):
        c = config.common
        dc = config.common_depth
        self.config = config
        self.common = c
        self.dc = dc
        self.size = (config.input_height, config.input_width)
        self.padding = tuple(config.padding)
        self.nside = config.nside
        self.base_pix = config.base_pix
        self.rotate_pole = c.rotate_pole
        self.pred_part = config.pred_part
        self.data_transform = dc.data_transform
        self.normalize_data = dc.normalize_data
        self.mask_background = dc.mask_background
        self.woodscape_version = c.version if c.version != "woodscape" else "synwoodscape"
        self.overfit_batches = c.manual_overfit_batches

        kwargs = dict(
            cam_pos=c.cam_pos, train_share=c.train_share, size=self.size,
            padding=self.padding, shuffle_train_val_split=config.shuffle_train_val_split,
            data_transform=dc.data_transform, normalize_data=dc.normalize_data,
            mask_background=dc.mask_background, woodscape_version=self.woodscape_version,
        )
        self.train_dataset = flat_depth_datasets.WoodscapeDepthDataset(part="train", **kwargs)
        self.val_dataset = flat_depth_datasets.WoodscapeDepthDataset(part="val", **kwargs)
        kwargs.pop("train_share")
        pred_samples = -1 if self.overfit_batches > 0 else c.pred_samples
        self.pred_dataset = WoodscapeDepthImagesPredictDataset(
            samples=pred_samples, base_train_share=c.train_share, part=config.pred_part,
            nside=config.nside, base_pix=config.base_pix, rotate_pole=c.rotate_pole,
            **kwargs,
        )

        self.train_indices = None
        if self.overfit_batches > 0:
            n = self.overfit_batches * c.batch_size
            rng = np.random.RandomState(c.seed or 0)
            self.train_indices = rng.permutation(len(self.train_dataset))[:n]
        # reference get_pred_overfit_sampler: predict ranks/scores ONLY the
        # overfit samples (matched by name), not the whole train split
        self.pred_indices = None
        if self.train_indices is not None:
            self.pred_indices = pred_overfit_indices(
                self.train_dataset, self.train_indices, self.pred_dataset
            )

    def train_dataloader(self):
        return DataLoader(
            self.train_dataset, batch_size=self.common.batch_size,
            shuffle=self.common.shuffle and self.overfit_batches == 0,
            seed=self.common.seed or 0, drop_last=True, indices=self.train_indices,
            num_workers=self.common.train_worker,  # reference hp_datasets.py:318
        )

    def val_dataloader(self):
        if self.overfit_batches > 0:
            return self.train_dataloader()
        return DataLoader(self.val_dataset, batch_size=self.common.val_batch_size,
                          shuffle=False, num_workers=self.common.val_worker)

    def predict_dataloader(self):
        return DataLoader(
            self.pred_dataset, batch_size=self.common.pred_batch_size, shuffle=False,
            collate_fn=default_collate, indices=self.pred_indices,
            num_workers=self.common.val_worker,  # reference hp_datasets.py:343
        )

    def get_img_features(self):
        return 3

    def get_img_dims(self):
        img, _ = self.train_dataset[0]
        return tuple(img.shape[:2])

    def get_classes(self):
        return 1

    def get_class_names(self):
        return None

    def get_original_img_dims(self):
        cal = self.pred_dataset[0]["cal_infos"]
        return int(cal["intrinsic"]["height"]), int(cal["intrinsic"]["width"])

    def get_pred_writer(self, pred_writer_name, **kwargs):
        """The writers that draw nothing (``val_on_hp_projected``, ``chamfer_distance``),
        with the JAX datamodule's defaults; the base and best/worst writers (and None,
        the base writer) draw with matplotlib and raise, naming the item that brings
        them."""
        from heal_swin_torch.evaluation import flat_depth_pred_writers

        writers = {
            "val_on_hp_projected":
                flat_depth_pred_writers.WoodscapeFlatDepthValOnHPProjectedPredictionWriter,
            "chamfer_distance":
                flat_depth_pred_writers.WoodscapeFlatDepthChamferDistBestWorstPredictionWriter,
        }
        if pred_writer_name in (None, "base_writer", "best_worst_preds"):
            raise NotImplementedError(
                f"prediction writer {pred_writer_name!r}: the depth writers that draw wait "
                "for a way to draw without matplotlib (ROADMAP queue 1 item 8); the port "
                f"has {list(writers)}")
        assert pred_writer_name in writers, (
            f"prediction writer {pred_writer_name} unknown, implemented: {list(writers)}"
        )
        kwargs.setdefault("rotate_pole", self.rotate_pole)
        kwargs.setdefault("f_out", self.get_classes())
        kwargs.setdefault("nside", self.nside)
        kwargs.setdefault("base_pix", self.base_pix)
        kwargs.setdefault("part", self.pred_part)
        kwargs.setdefault("pred_dataset", self.pred_dataset)
        kwargs.setdefault("data_transform", self.data_transform)
        kwargs.setdefault("mask_background", self.mask_background)
        kwargs.setdefault("normalize_data", self.normalize_data)
        kwargs.setdefault("img_dims", self.get_img_dims())
        kwargs.setdefault("padding", self.padding)
        kwargs.setdefault("orig_size", self.get_original_img_dims())
        return writers[pred_writer_name](**kwargs)
