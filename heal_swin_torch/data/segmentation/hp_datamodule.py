"""HEALPix segmentation datasets + datamodule for WoodScape
(reference heal_swin/data/segmentation/hp_datasets.py).

Datasets read the per-sample .npz files generated by project_on_s2 (auto-triggered if
the derived dataset dir is missing, reference :53-71).  Model-facing arrays are
channels-last ((npix, 3) float32); the on-disk format stays reference-compatible
((3, npix) uint8).  The port's copy of ``heal_swin_tpu/data/segmentation/hp_datamodule.py``:
its device batch transforms are torch ops on the batch's device
(``projection/device.py``), and ``get_pred_writer`` serves the four HEALPix writers of
``evaluation/hp_pred_writers.py``; the predict dataset reads the npz projection in
either mode."""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from heal_swin_torch.data.loading import (
    DataLoader,
    default_collate,
    pred_overfit_indices,
)
from heal_swin_torch.data.segmentation import flat_datasets
from heal_swin_torch.data.woodscape_dataset import WoodscapeDataset
from heal_swin_torch.ops.healpix import isnsideok
from heal_swin_torch.projection.device import DeviceProjector
from heal_swin_torch.utils.utils import get_datasets_path


def get_seg_info(woodscape_version):
    """Class names/colors metadata (reference utils.get_seg_info, utils.py:35-46)."""
    path = os.path.join(
        get_datasets_path() / woodscape_version,
        "semantic_annotations",
        "seg_annotation_info.json",
    )
    with open(path) as f:
        return json.load(f)


def hp_dataset_name(nside, base_pix, crop_green, s2_bkgd_class, rotate_pole):
    """Derived dataset dir name (reference hp_datasets.py:46-52)."""
    name = f"hp_images_nside={nside}_base_pix={base_pix}_crop_green={crop_green}"
    name += f"_s2_bkgd_class={s2_bkgd_class}" if s2_bkgd_class != 0 else ""
    name += "_rotate_pole" if rotate_pole else ""
    return name


class WoodscapeHPSemanticImagesDataset(WoodscapeDataset):
    """(hp_img (3, npix) uint8, hp_mask (npix,) uint8) from .npz; auto-generates the
    projected dataset if missing (reference hp_datasets.py:20-102)."""

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
        woodscape_version=None,
        training_data_fraction=1.0,
        data_fraction_seed=42,
    ):
        assert isnsideok(nside)
        assert 1 <= base_pix <= 12
        self.nside = nside
        self.base_pix = base_pix
        self.crop_green = crop_green

        dataset_name = hp_dataset_name(nside, base_pix, crop_green, s2_bkgd_class, rotate_pole)
        self.root_dir = os.path.join(get_datasets_path() / woodscape_version, dataset_name)
        if not os.path.isdir(self.root_dir):
            print(
                f"HEALPix dataset not found at {self.root_dir}, generating dataset..."
            )
            from heal_swin_torch.data.segmentation import project_on_s2

            args_list = [
                "--nside", str(nside), "--samples", "-1", "--base_pix", str(base_pix),
                "--save_imgs_to", dataset_name, "--part", "both",
                "--s2_bkgd_class", str(s2_bkgd_class),
                "--woodscape_version", woodscape_version,
            ]
            if rotate_pole:
                args_list.append("--rotate_pole")
            if crop_green:
                args_list.append("--crop_green")
            parser = argparse.ArgumentParser()
            args = project_on_s2.add_args(parser).parse_args(args_list)
            project_on_s2.main(args)

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

    def get_dir(self):
        return self.root_dir

    def get_extension(self):
        return ".npz"

    def load_raw(self, idx):
        data = np.load(self.paths[idx])
        return data["hp_img"], data["hp_mask"]

    def __getitem__(self, idx):
        hp_img, hp_mask = self.load_raw(idx)
        # channels-last, uint8 wire format: train/val samples ship as the on-disk
        # uint8 and the datamodule's device_batch_transform casts them to f32/i32
        # on the device (4x fewer bytes per batch on the host->device copy).
        return hp_img.T, hp_mask

    def get_item_by_name(self, name):
        return self.load_raw(self.names.index(name))


class WoodscapeHPSemanticImagesPredictDataset:
    """HP sample + original flat image/mask + calibration joined by name
    (reference hp_datasets.py:105-217)."""

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
        rotate_pole=False,
        woodscape_version=None,
        training_data_fraction=1.0,
        data_fraction_seed=42,
    ):
        dataset_kwargs = dict(
            nside=nside, base_pix=base_pix, crop_green=crop_green, cam_pos=cam_pos,
            s2_bkgd_class=s2_bkgd_class, rotate_pole=rotate_pole,
            shuffle_train_val_split=shuffle_train_val_split,
            woodscape_version=woodscape_version,
            training_data_fraction=training_data_fraction,
            data_fraction_seed=data_fraction_seed,
        )
        train_share = _samples_to_train_share(
            samples, part, base_train_share,
            lambda: len(
                WoodscapeHPSemanticImagesDataset(part="train", train_share=1.0, **dataset_kwargs)
            ),
        )
        if isinstance(samples, int) and samples == -1:
            part = "train"

        self.hp_imgs_masks_dataset = WoodscapeHPSemanticImagesDataset(
            part=part, train_share=train_share, **dataset_kwargs
        )
        self.imgs_masks_cal_dataset = flat_datasets.WoodscapeSemanticImagesCalibrationDataset(
            crop_green=crop_green, cam_pos=cam_pos, train_share=0, part="val",
            woodscape_version=woodscape_version,
        )

    def __len__(self):
        return len(self.hp_imgs_masks_dataset)

    @property
    def names(self):
        """Sample names by index (overfit predict subset / writer lookups)."""
        return self.hp_imgs_masks_dataset.names

    def __getitem__(self, idx):
        hp_img, hp_mask = self.hp_imgs_masks_dataset.load_raw(idx)
        hp_name = self.hp_imgs_masks_dataset.names[idx]
        img, mask, cal_info, name = self.imgs_masks_cal_dataset.get_item_by_name(hp_name)
        assert name == hp_name
        return {
            "hp_imgs": hp_img.T.astype(np.float32),  # (npix, 3) model input
            "hp_masks": hp_mask.astype(np.int32),
            "imgs": img,  # (C, H, W) uint8 original
            "masks": mask,  # (H, W) uint8 original
            "cal_infos": cal_info,
            "names": name,
        }


def _samples_to_train_share(samples, part, base_train_share, total_fn):
    """Map pred_samples (count or fraction) to a train_share so the predict set is the
    last N samples of the chosen part (reference hp_datasets.py:147-168)."""
    if isinstance(samples, float):
        assert 0.0 < samples <= 1.0
        if part == "train":
            return base_train_share * samples
        return base_train_share + ((1 - samples) * (1 - base_train_share))
    total = total_fn()
    if samples == -1:
        return 1.0
    assert samples <= total, f"requested {samples} predict samples of {total}"
    if part == "train":
        return samples / total
    return 1 - samples / total


class _OnDeviceProjectionDataset:
    """Flat (img (H, W, 3) uint8, (mask (H, W), cal_id int32)) samples for the
    project_on_device input pipeline: the host only decodes; the fisheye->HEALPix
    gather runs on the device (projection/device.py)."""

    def __init__(self, flat_ds, mask_dtype=np.uint8):
        self.flat = flat_ds
        self.mask_dtype = mask_dtype
        # cluster identical calibrations -> one projection table per cluster
        self.cal_infos = []
        self._key_to_id = {}
        self.cal_ids = np.zeros(len(flat_ds), dtype=np.int32)
        for i in range(len(flat_ds)):
            cal = flat_ds.cals_dataset[i]
            key = json.dumps(
                {k: cal[k] for k in ("intrinsic", "extrinsic")}, sort_keys=True
            )
            if key not in self._key_to_id:
                self._key_to_id[key] = len(self.cal_infos)
                self.cal_infos.append(cal)
            self.cal_ids[i] = self._key_to_id[key]

    def __len__(self):
        return len(self.flat)

    @property
    def names(self):
        return self.flat.names

    def __getitem__(self, idx):
        img, mask, _, _ = self.flat[idx]
        # uint8 wire format (see WoodscapeHPSemanticImagesDataset.__getitem__);
        # the device transform casts to f32 before the projection gathers.
        img = np.asarray(img)
        if img.ndim == 3 and img.shape[0] in (1, 3):  # (C, H, W) -> (H, W, C)
            img = img.transpose(1, 2, 0)
        return img, (np.asarray(mask, dtype=self.mask_dtype), self.cal_ids[idx])


def merge_cal_ids(*datasets):
    """Merge the calibration clusters of ``_OnDeviceProjectionDataset``s into one id
    space: each dataset's ``cal_ids`` are renumbered in place.  Returns the merged
    clusters' calibrations by id."""
    merged: dict = {}
    for ds in datasets:
        remap = np.zeros(max(len(ds.cal_infos), 1), dtype=np.int32)
        for key, local_id in ds._key_to_id.items():
            if key not in merged:
                merged[key] = (len(merged), ds.cal_infos[local_id])
            remap[local_id] = merged[key][0]
        ds.cal_ids = remap[ds.cal_ids]
    return [ci for _, ci in sorted(merged.values(), key=lambda t: t[0])]


class WoodscapeHPSegmentationDataModule:
    """reference hp_datasets.py:220-420; constructed from WoodscapeHPConfig."""

    def __init__(self, config):
        c = config.common
        assert c.s2_bkgd_class in range(11)
        self.config = config
        self.common = c
        self.nside = config.input_nside
        self.base_pix = config.input_base_pix
        self.s2_bkgd_class = c.s2_bkgd_class
        self.rotate_pole = c.rotate_pole
        self.pred_part = config.pred_part
        self.woodscape_version = c.version
        self.overfit_batches = c.manual_overfit_batches
        self.project_on_device = getattr(config, "project_on_device", False)

        kwargs = dict(
            nside=self.nside, base_pix=self.base_pix, crop_green=c.crop_green,
            cam_pos=c.cam_pos, train_share=c.train_share, s2_bkgd_class=c.s2_bkgd_class,
            rotate_pole=c.rotate_pole, shuffle_train_val_split=config.shuffle_train_val_split,
            woodscape_version=c.version, training_data_fraction=c.training_data_fraction,
            data_fraction_seed=c.data_fraction_seed,
        )
        if self.project_on_device:
            assert not c.crop_green, "project_on_device does not support crop_green"
            flat_kwargs = dict(
                cam_pos=c.cam_pos, train_share=c.train_share,
                shuffle_train_val_split=config.shuffle_train_val_split,
                woodscape_version=c.version,
                training_data_fraction=c.training_data_fraction,
                data_fraction_seed=c.data_fraction_seed,
            )
            self.train_dataset = _OnDeviceProjectionDataset(
                flat_datasets.WoodscapeSemanticImagesCalibrationDataset(
                    part="train", **flat_kwargs
                )
            )
            self.val_dataset = _OnDeviceProjectionDataset(
                flat_datasets.WoodscapeSemanticImagesCalibrationDataset(
                    part="val", **flat_kwargs
                )
            )
            self._cal_infos = merge_cal_ids(self.train_dataset, self.val_dataset)
            self._projector = None
            self.device_batch_transform = self._device_project_batch
        else:
            self.train_dataset = WoodscapeHPSemanticImagesDataset(part="train", **kwargs)
            self.val_dataset = WoodscapeHPSemanticImagesDataset(part="val", **kwargs)
            self.device_batch_transform = self._device_cast_batch
        kwargs.pop("train_share")
        pred_samples = -1 if self.overfit_batches > 0 else c.pred_samples
        self.pred_dataset = WoodscapeHPSemanticImagesPredictDataset(
            samples=pred_samples, base_train_share=c.train_share, part=config.pred_part, **kwargs
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

    @staticmethod
    def _device_cast_batch(imgs, targets):
        """The uint8 wire format cast to the model's dtypes on the device."""
        return imgs.float(), targets.int()

    def _device_project_batch(self, imgs, targets):
        """Batched fisheye->HEALPix projection of flat images + masks on the batch's
        device.  Floors to the uint8 grid for parity with the on-disk npz pipeline
        (project_on_s2.py)."""
        if self._projector is None:
            self._projector = DeviceProjector(
                self._cal_infos, self.nside, self.base_pix, self.rotate_pole
            )
        masks, cal_ids = targets
        hp_imgs = self._projector.project_images(imgs.float(), cal_ids)
        hp_imgs = torch.floor(torch.clamp(hp_imgs, 0.0, 255.0))
        hp_masks = self._projector.project_masks(masks, cal_ids, self.s2_bkgd_class)
        return hp_imgs, hp_masks.int()

    def get_img_dims(self):
        if self.project_on_device:
            return self.base_pix * self.nside**2  # npix_used
        img, _ = self.train_dataset[0]
        return img.shape[0]  # npix (channels-last)

    def get_classes(self):
        n = len(self.get_class_names())
        return n + 1 if self.s2_bkgd_class not in range(n) else n

    def get_class_names(self):
        return get_seg_info(self.woodscape_version)["class_names"]

    def get_original_img_dims(self):
        cal = self.pred_dataset[0]["cal_infos"]
        return int(cal["intrinsic"]["height"]), int(cal["intrinsic"]["width"])

    def get_pred_writer(self, pred_writer_name, **kwargs):
        from heal_swin_torch.evaluation import hp_pred_writers

        writers = {
            None: hp_pred_writers.WoodscapeHPBasePredictionWriter,
            "base_writer": hp_pred_writers.WoodscapeHPBasePredictionWriter,
            "val_on_back_projected": hp_pred_writers.WoodscapeHPValOnBackProjectedPredictionWriter,
            "best_worst_preds": hp_pred_writers.WoodscapeHPBestWorstPredictionWriter,
            "back_projected_hp_masked_iou":
                hp_pred_writers.WoodscapeHPBackProjectedHPMaskedIoUPredictionWriter,
        }
        assert pred_writer_name in writers, (
            f"prediction writer {pred_writer_name} unknown, implemented: {list(writers)}"
        )
        kwargs.setdefault("rotate_pole", self.rotate_pole)
        kwargs.setdefault("f_out", self.get_classes())
        kwargs.setdefault("nside", self.nside)
        kwargs.setdefault("base_pix", self.base_pix)
        kwargs.setdefault("part", self.pred_part)
        kwargs.setdefault("s2_bkgd_class", self.s2_bkgd_class)
        kwargs.setdefault("pred_dataset", self.pred_dataset)
        kwargs.setdefault("img_dims", self.get_original_img_dims())
        kwargs.setdefault("woodscape_version", self.woodscape_version)
        return writers[pred_writer_name](**kwargs)
