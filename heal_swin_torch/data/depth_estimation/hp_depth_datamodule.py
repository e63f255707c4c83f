"""HEALPix depth datasets + datamodule
(reference heal_swin/data/depth_estimation/hp_depth_datasets.py).  The port's copy of
``heal_swin_tpu/data/depth_estimation/hp_depth_datamodule.py``: its device batch
transform is torch ops on the batch's device, and ``get_pred_writer`` has the writers
that draw nothing and raises for the rest (ROADMAP queue 1 item 8)."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from heal_swin_torch.data import normalize_depth_data as ndd
from heal_swin_torch.data.depth_estimation import flat_depth_datasets
from heal_swin_torch.data.depth_estimation.flat_depth_datasets import apply_depth_mask_pipeline
from heal_swin_torch.data.depth_estimation.project_depth_on_s2 import hp_depth_dataset_name
from heal_swin_torch.data.loading import (
    DataLoader,
    default_collate,
    pred_overfit_indices,
)
from heal_swin_torch.data.segmentation.hp_datamodule import (
    _OnDeviceProjectionDataset,
    _samples_to_train_share,
    merge_cal_ids,
)
from heal_swin_torch.data.woodscape_dataset import WoodscapeDataset
from heal_swin_torch.ops.healpix import isnsideok
from heal_swin_torch.projection.device import DeviceProjector
from heal_swin_torch.utils.utils import get_datasets_path


class WoodscapeHPDepthImagesDataset(WoodscapeDataset):
    """(hp_img (npix, 3) float32, hp_mask (npix,) float32 network-space) from .npz;
    auto-generates the projected dataset if missing (reference :16-113)."""

    def __init__(
        self,
        nside=256,
        crop_green=False,
        cam_pos=None,
        train_share=0.8,
        shuffle_train_val_split=True,
        part="train",
        s2_bkgd_class=0,
        rotate_pole=False,
        base_pix=8,
        mask_background=False,
        data_transform=None,
        normalize_data=None,
        woodscape_version="synwoodscape",
        training_data_fraction=1.0,
        data_fraction_seed=42,
    ):
        assert isnsideok(nside)
        assert 1 <= base_pix <= 12
        self.nside = nside
        self.base_pix = base_pix
        self.mask_background = mask_background
        self.data_transform = data_transform
        self.normalize_data = normalize_data

        dataset_name = hp_depth_dataset_name(nside, base_pix, rotate_pole)
        self.root_dir = os.path.join(get_datasets_path() / woodscape_version, dataset_name)
        if not os.path.isdir(self.root_dir):
            print(f"HP depth dataset not found at {self.root_dir}, generating dataset...")
            from heal_swin_torch.data.depth_estimation import project_depth_on_s2

            args_list = [
                "--nside", str(nside), "--samples", "-1", "--base_pix", str(base_pix),
                "--save_imgs_to", dataset_name, "--part", "both", "--grid", "hp",
                "--woodscape_version", woodscape_version,
            ]
            if rotate_pole:
                args_list.append("--rotate_pole")
            parser = argparse.ArgumentParser()
            args = project_depth_on_s2.add_args(parser).parse_args(args_list)
            project_depth_on_s2.main(args)

        super().__init__(
            cam_pos=cam_pos,
            train_share=train_share,
            part=part,
            shuffle_train_val_split=shuffle_train_val_split,
            woodscape_version=woodscape_version,
            training_data_fraction=training_data_fraction,
            data_fraction_seed=data_fraction_seed,
        )
        self.names = [os.path.splitext(f)[0] for f in self.file_names]
        self.data_stats = ndd.get_depth_data_stats(data_transform, mask_background)

    def get_dir(self):
        return self.root_dir

    def get_extension(self):
        return ".npz"

    def load_raw(self, idx):
        data = np.load(self.paths[idx])
        return data["hp_img"], data["hp_mask"]

    def __getitem__(self, idx):
        hp_img, hp_mask = self.load_raw(idx)
        hp_mask = apply_depth_mask_pipeline(
            hp_mask, self.mask_background, self.data_transform, self.normalize_data,
            self.data_stats,
        )
        return hp_img.T.astype(np.float32), hp_mask

    def get_item_by_name(self, name):
        return self[self.names.index(name)]


class WoodscapeHPDepthImagesPredictDataset:
    """HP depth sample + original flat image/depth + calibration (reference :116-235)."""

    def __init__(
        self,
        nside=256,
        base_pix=8,
        crop_green=False,
        cam_pos=None,
        samples=40,
        base_train_share=0.8,
        shuffle_train_val_split=True,
        part="val",
        s2_bkgd_class=0,
        data_transform=None,
        normalize_data=None,
        rotate_pole=False,
        mask_background=False,
        woodscape_version="synwoodscape",
    ):
        kwargs = dict(
            nside=nside, base_pix=base_pix, crop_green=crop_green, cam_pos=cam_pos,
            s2_bkgd_class=s2_bkgd_class, rotate_pole=rotate_pole,
            shuffle_train_val_split=shuffle_train_val_split, mask_background=mask_background,
            woodscape_version=woodscape_version,
        )
        train_share = _samples_to_train_share(
            samples, part, base_train_share,
            lambda: len(
                WoodscapeHPDepthImagesDataset(
                    part="train", train_share=1.0, data_transform=data_transform,
                    normalize_data=normalize_data, **kwargs,
                )
            ),
        )
        if isinstance(samples, int) and samples == -1:
            part = "train"

        self.hp_imgs_masks_dataset = WoodscapeHPDepthImagesDataset(
            part=part, train_share=train_share, data_transform=data_transform,
            normalize_data=normalize_data, **kwargs,
        )
        self.imgs_masks_cal_dataset = flat_depth_datasets.WoodscapeDepthImagesCalibrationDataset(
            crop_green=crop_green, cam_pos=cam_pos, train_share=train_share, part=part,
            data_transform=data_transform, normalize_data=normalize_data,
            mask_background=mask_background, woodscape_version=woodscape_version,
        )

    def __len__(self):
        return len(self.hp_imgs_masks_dataset)

    @property
    def names(self):
        """Sample names by index (writers resolve ranked names in O(1))."""
        return self.hp_imgs_masks_dataset.names

    def __getitem__(self, idx):
        hp_img_cl, hp_mask = self.hp_imgs_masks_dataset[idx]
        hp_name = self.hp_imgs_masks_dataset.names[idx]
        img, mask, cal_info, name = self.imgs_masks_cal_dataset.get_item_by_name(hp_name)
        assert name == hp_name
        return {
            "hp_imgs": hp_img_cl,  # (npix, 3) model input
            "hp_masks": hp_mask,  # network-space depth targets
            "imgs": img,  # (C, H, W) original
            "masks": mask,  # (H, W) raw metric depth map
            "cal_infos": cal_info,
            "names": name,
        }


class WoodscapeHPDepthDataModule:
    """reference hp_depth_datasets.py:238-443; constructed from WoodscapeHPDepthConfig."""

    def __init__(self, config):
        c = config.common
        dc = config.common_depth
        self.config = config
        self.common = c
        self.dc = dc
        self.nside = config.input_nside
        self.base_pix = config.input_base_pix
        self.rotate_pole = c.rotate_pole
        self.pred_part = config.pred_part
        self.data_transform = dc.data_transform
        self.normalize_data = dc.normalize_data
        self.mask_background = dc.mask_background
        self.woodscape_version = c.version if c.version != "woodscape" else "synwoodscape"
        self.overfit_batches = c.manual_overfit_batches

        kwargs = dict(
            nside=self.nside, base_pix=self.base_pix, cam_pos=c.cam_pos,
            train_share=c.train_share, rotate_pole=c.rotate_pole,
            shuffle_train_val_split=config.shuffle_train_val_split,
            data_transform=dc.data_transform, normalize_data=dc.normalize_data,
            mask_background=dc.mask_background, woodscape_version=self.woodscape_version,
        )
        self.project_on_device = getattr(config, "project_on_device", False)
        if self.project_on_device:
            # on-device projection pipeline (see segmentation/hp_datamodule.py): the
            # host decodes the flat image + raw depth map; the projection + the full
            # depth mask pipeline (0->inf, background, transform, normalize) run on the
            # device
            assert not c.crop_green, "project_on_device does not support crop_green"
            flat_kwargs = dict(
                cam_pos=c.cam_pos, train_share=c.train_share,
                shuffle_train_val_split=config.shuffle_train_val_split,
                woodscape_version=self.woodscape_version,
            )
            self.train_dataset = _OnDeviceProjectionDataset(
                flat_depth_datasets.WoodscapeDepthImagesCalibrationDataset(part="train", **flat_kwargs),
                mask_dtype=np.float32,
            )
            self.val_dataset = _OnDeviceProjectionDataset(
                flat_depth_datasets.WoodscapeDepthImagesCalibrationDataset(part="val", **flat_kwargs),
                mask_dtype=np.float32,
            )
            self._cal_infos = merge_cal_ids(self.train_dataset, self.val_dataset)
            self._projector = None
            self.data_stats = ndd.get_depth_data_stats(dc.data_transform, dc.mask_background)
            self.device_batch_transform = self._device_project_batch
        else:
            self.train_dataset = WoodscapeHPDepthImagesDataset(part="train", **kwargs)
            self.val_dataset = WoodscapeHPDepthImagesDataset(part="val", **kwargs)
        kwargs.pop("train_share")
        pred_samples = -1 if self.overfit_batches > 0 else c.pred_samples
        self.pred_dataset = WoodscapeHPDepthImagesPredictDataset(
            samples=pred_samples, base_train_share=c.train_share, part=config.pred_part,
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

    def _device_project_batch(self, imgs, targets):
        """The projection + the reference's depth mask pipeline (0->inf, optional
        1000->inf, transform, normalize; hp_depth_datasets.py:90-108 semantics) on the
        batch's device.  The images are not floored (the npz depth pipeline keeps them
        float32)."""
        if self._projector is None:
            self._projector = DeviceProjector(
                self._cal_infos, self.nside, self.base_pix, self.rotate_pole
            )
        depths, cal_ids = targets
        # imgs arrive as the uint8 wire format (_OnDeviceProjectionDataset)
        hp_imgs = self._projector.project_images(imgs.float(), cal_ids)
        m = self._projector.project_masks(depths, cal_ids, 0)
        inf = torch.tensor(float("inf"), dtype=m.dtype, device=m.device)
        m = torch.where(m == 0.0, inf, m)
        if self.mask_background:
            m = torch.where(m == 1000.0, inf, m)
        m = ndd.mask_transform_fcn(self.data_transform)(m)
        m = ndd.normalize_data(m, self.data_stats, self.normalize_data)
        return hp_imgs, m.float()

    def get_img_features(self):
        return 3

    def get_img_dims(self):
        if self.project_on_device:
            return self.base_pix * self.nside**2
        img, _ = self.train_dataset[0]
        return img.shape[0]

    def get_classes(self):
        return 1

    def get_class_names(self):
        return None

    def get_original_img_dims(self):
        cal = self.pred_dataset[0]["cal_infos"]
        return int(cal["intrinsic"]["height"]), int(cal["intrinsic"]["width"])

    def get_pred_writer(self, pred_writer_name, **kwargs):
        """The writers that draw nothing (``val_on_back_projected``,
        ``chamfer_distance``), with the JAX datamodule's defaults; the base and best/worst
        writers (and None, the base writer) draw with matplotlib and raise, naming the
        item that brings them."""
        from heal_swin_torch.evaluation import hp_depth_pred_writers

        writers = {
            "val_on_back_projected":
                hp_depth_pred_writers.WoodscapeHPDepthValOnBackProjectedPredictionWriter,
            "chamfer_distance":
                hp_depth_pred_writers.WoodscapeHPDepthChamferDistBestWorstPredictionWriter,
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
        kwargs.setdefault("img_dims", self.get_original_img_dims())
        return writers[pred_writer_name](**kwargs)
