"""Flat segmentation datamodule for WoodScape (the port's copy of
``heal_swin_tpu/data/segmentation/flat_datamodule.py``; reference
heal_swin/data/segmentation/flat_datamodule.py).

Model-facing arrays are channels-last: train and validation samples ship as uint8
((H, W, 3) images, (H, W) masks) and the datamodule's ``device_batch_transform`` casts
them to float32 / int32 on the device; predict batches carry (H, W, 3) float32 images,
the matching HP sample, the unresized originals and the calibration for the projection
writers."""

from __future__ import annotations

import os

import numpy as np

from heal_swin_torch.data.loading import (
    DataLoader,
    default_collate,
    pred_overfit_indices,
)
from heal_swin_torch.data.segmentation import flat_datasets
from heal_swin_torch.data.segmentation.hp_datamodule import (
    WoodscapeHPSemanticImagesDataset,
    _samples_to_train_share,
    get_seg_info,
)


class _ModelFacingSemanticImages(flat_datasets.WoodscapeSemanticImagesDataset):
    """(img (H, W, 3) uint8, mask (H, W) uint8): the uint8 wire format, 4x fewer bytes
    a batch on the host -> device copy; the datamodule's ``device_batch_transform``
    casts to float32 / int32 on the device."""

    def __getitem__(self, idx):
        img, mask = super().__getitem__(idx)
        return img.transpose(1, 2, 0), mask


class WoodscapeSemanticImagesPredictDataset:
    """reference flat_datamodule.py:14-131: resized pair + originals + calibration +
    the matching HP sample (for val_on_hp_projected writers)."""

    def __init__(
        self,
        crop_green=False,
        cam_pos=None,
        samples=40,
        base_train_share=0.8,
        part="val",
        size=None,
        padding=(0, 0, 0, 0),
        shuffle_train_val_split=True,
        nside=256,
        base_pix=8,
        s2_bkgd_class=0,
        rotate_pole=False,
        woodscape_version=None,
        training_data_fraction=1.0,
        data_fraction_seed=42,
    ):
        kwargs = dict(
            crop_green=crop_green, cam_pos=cam_pos, size=size, padding=padding,
            shuffle_train_val_split=shuffle_train_val_split,
            woodscape_version=woodscape_version,
            training_data_fraction=training_data_fraction,
            data_fraction_seed=data_fraction_seed,
        )
        train_share = _samples_to_train_share(
            samples, part, base_train_share,
            lambda: len(
                flat_datasets.WoodscapeSemanticImagesDataset(
                    part="train", train_share=1.0, **kwargs
                )
            ),
        )
        if isinstance(samples, int) and samples == -1:
            part = "train"

        self.transf_sem_img_dataset = flat_datasets.WoodscapeSemanticImagesDataset(
            part=part, train_share=train_share, **kwargs
        )
        kwargs_nosize = dict(kwargs, size=None)
        self.sem_img_dataset = flat_datasets.WoodscapeSemanticImagesCalibrationDataset(
            part=part, train_share=train_share, **kwargs_nosize
        )
        self.hp_dataset = WoodscapeHPSemanticImagesDataset(
            crop_green=crop_green, cam_pos=cam_pos, train_share=0, part="val",
            nside=nside, base_pix=base_pix, s2_bkgd_class=s2_bkgd_class,
            rotate_pole=rotate_pole, woodscape_version=woodscape_version,
        )

    def __len__(self):
        return len(self.sem_img_dataset)

    @property
    def names(self):
        """Sample names by index (overfit predict subset / writer lookups)."""
        return self.sem_img_dataset.names

    def __getitem__(self, idx):
        transf_img, transf_mask = self.transf_sem_img_dataset[idx]
        img, mask, cal_info, name = self.sem_img_dataset[idx]
        assert name == os.path.splitext(self.transf_sem_img_dataset.file_names[idx])[0]
        hp_img, hp_mask = self.hp_dataset.get_item_by_name(name)
        return {
            "s2_imgs": transf_img.transpose(1, 2, 0).astype(np.float32),
            "s2_masks": transf_mask.astype(np.int32),
            "imgs": img,
            "masks": mask,
            "cal_infos": cal_info,
            "hp_imgs": hp_img,  # (3, npix) uint8, raw (for writers)
            "hp_masks": hp_mask.astype(np.int32),
            "names": name,
        }


class WoodscapeFlatSegmentationDataModule:
    """reference flat_datamodule.py:134-335; constructed from WoodscapeFlatConfig."""

    def __init__(self, config):
        c = config.common
        self.config = config
        self.common = c
        self.size = (config.input_height, config.input_width)
        self.padding = tuple(config.padding)
        self.s2_bkgd_class = c.s2_bkgd_class
        self.nside = config.nside
        self.base_pix = config.base_pix
        self.rotate_pole = c.rotate_pole
        self.pred_part = config.pred_part
        self.woodscape_version = c.version
        self.overfit_batches = c.manual_overfit_batches

        kwargs = dict(
            crop_green=c.crop_green, cam_pos=c.cam_pos, train_share=c.train_share,
            size=self.size, padding=self.padding,
            shuffle_train_val_split=config.shuffle_train_val_split,
            woodscape_version=c.version, training_data_fraction=c.training_data_fraction,
            data_fraction_seed=c.data_fraction_seed,
        )
        self.train_dataset = _ModelFacingSemanticImages(part="train", **kwargs)
        self.val_dataset = _ModelFacingSemanticImages(part="val", **kwargs)
        self.device_batch_transform = self._device_cast_batch
        kwargs.pop("train_share")
        pred_samples = -1 if self.overfit_batches > 0 else c.pred_samples
        self.pred_dataset = WoodscapeSemanticImagesPredictDataset(
            samples=pred_samples, base_train_share=c.train_share, part=config.pred_part,
            nside=config.nside, base_pix=config.base_pix, s2_bkgd_class=c.s2_bkgd_class,
            rotate_pole=c.rotate_pole, **kwargs,
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

    @staticmethod
    def _device_cast_batch(imgs, targets):
        """The uint8 wire format cast to the model's dtypes on the device."""
        return imgs.float(), targets.int()

    def get_img_features(self):
        return 3

    def get_img_dims(self):
        img, _ = self.train_dataset[0]
        return tuple(img.shape[:2])  # (H, W), channels-last

    def get_classes(self):
        return len(self.get_class_names())

    def get_class_names(self):
        return get_seg_info(self.woodscape_version)["class_names"]

    def get_pred_writer(self, pred_writer_name, **kwargs):
        from heal_swin_torch.evaluation import flat_pred_writers

        writers = {
            None: flat_pred_writers.WoodscapeFlatBasePredictionWriter,
            "base_writer": flat_pred_writers.WoodscapeFlatBasePredictionWriter,
            "best_worst_preds": flat_pred_writers.WoodscapeFlatBestWorstPredictionWriter,
            "val_on_hp_projected": flat_pred_writers.WoodscapeFlatValOnHPProjectedPredictionWriter,
            "hp_masked_iou": flat_pred_writers.WoodscapeFlatHPMaskedIoUPredictionWriter,
        }
        assert pred_writer_name in writers, (
            f"prediction writer {pred_writer_name} unknown, implemented: {list(writers)}"
        )
        cal = self.pred_dataset[0]["cal_infos"]["intrinsic"]
        kwargs.setdefault("f_out", self.get_classes())
        kwargs.setdefault("part", self.pred_part)
        kwargs.setdefault("pred_dataset", self.pred_dataset)
        kwargs.setdefault("img_dims", self.get_img_dims())
        kwargs.setdefault("nside", self.nside)
        kwargs.setdefault("base_pix", self.base_pix)
        kwargs.setdefault("s2_bkgd_class", self.s2_bkgd_class)
        kwargs.setdefault("rotate_pole", self.rotate_pole)
        kwargs.setdefault("padding", self.padding)
        kwargs.setdefault("orig_size", (int(cal["height"]), int(cal["width"])))
        kwargs.setdefault("woodscape_version", self.woodscape_version)
        return writers[pred_writer_name](**kwargs)
