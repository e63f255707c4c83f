"""Deterministic synthetic HEALPix datasets (the port's copy of the HP half of
``heal_swin_tpu/data/synthetic.py``): small, fully deterministic, learnable data made
in memory when a data config's ``version`` is "synthetic".  Class masks are smooth
functions of the pixel's direction, images are class-coloured with noise, depths are
smooth functions with the background at the reference's conventions (0 -> inf
markers).  The same config gives the same arrays as the JAX package's datamodules.

The flat datamodules wait for the port's flat SWIN-UNet.
"""

from __future__ import annotations

import numpy as np

from heal_swin_torch.data import normalize_depth_data as ndd
from heal_swin_torch.data.loading import DataLoader
from heal_swin_torch.ops import healpix as hpx

N_CLASSES = 4
CLASS_NAMES = ["background", "road", "object", "sky"]


def _class_pattern(theta, phi, n_classes=N_CLASSES):
    """Smooth angular class layout: bands in theta with a phi wobble."""
    t = theta + 0.15 * np.sin(3 * phi)
    edges = np.linspace(t.min() - 1e-6, t.max() + 1e-6, n_classes + 1)
    return np.clip(np.digitize(t, edges) - 1, 0, n_classes - 1).astype(np.uint8)


def _image_from_mask(mask, rng, n_classes=N_CLASSES):
    """(..., 3) uint8 image whose colours correlate with the class, plus noise."""
    palette = np.array(
        [[40, 40, 40], [90, 200, 90], [200, 90, 90], [90, 90, 220]], dtype=np.float32
    )[:n_classes]
    img = palette[mask.astype(int)]
    img = img + rng.normal(0, 20, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _depth_from_angles(theta, phi, mask):
    """Metric depths: smooth in theta, inf at the background class (the reference
    maps background/zero depths to inf, hp_depth_datasets.py:90-108)."""
    d = 8.0 + 50.0 * (theta / max(theta.max(), 1e-6)) + 5.0 * np.cos(2 * phi)
    d = d.astype(np.float32)
    d[mask == 0] = np.inf
    return d


class _SyntheticSegDatasetHP:
    def __init__(self, nside, base_pix, n_samples, seed):
        self.npix = base_pix * nside * nside
        theta, phi = hpx.pix2ang(nside, np.arange(self.npix), nest=True)
        base_mask = _class_pattern(theta, phi)
        self.samples = []
        for i in range(n_samples):
            rng = np.random.RandomState(seed + i)
            # rotate the pattern a little per sample so it is not constant
            shift = int(rng.randint(0, self.npix))
            mask = np.roll(base_mask, shift)
            img = _image_from_mask(mask, rng)
            self.samples.append((img, mask, f"synthetic_{i:05d}"))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        img, mask, _ = self.samples[i]
        return img.astype(np.float32), mask.astype(np.int32)


class _SyntheticSegPredictDatasetHP(_SyntheticSegDatasetHP):
    def __getitem__(self, i):
        img, mask, name = self.samples[i]
        return {
            "hp_imgs": img.astype(np.float32),
            "hp_masks": mask.astype(np.int32),
            "names": name,
        }


class _SyntheticDepthDatasetHP:
    def __init__(self, nside, base_pix, n_samples, seed, dc):
        self.npix = base_pix * nside * nside
        theta, phi = hpx.pix2ang(nside, np.arange(self.npix), nest=True)
        base_mask = _class_pattern(theta, phi)
        stats = ndd.get_depth_data_stats(dc.data_transform, dc.mask_background)
        self.samples = []
        for i in range(n_samples):
            rng = np.random.RandomState(seed + i)
            shift = int(rng.randint(0, self.npix))
            mask = np.roll(base_mask, shift)
            img = _image_from_mask(mask, rng)
            depth = _depth_from_angles(theta, phi, mask)
            depth = np.roll(depth, shift)
            # network-space targets (transform + normalize), as the reference's
            # dataset pipeline emits them (hp_depth_datasets.py:90-108)
            t = np.asarray(
                ndd.transform_and_normalize(depth, dc.normalize_data, stats, dc.data_transform)
            ).astype(np.float32)
            self.samples.append((img, t, f"synthetic_{i:05d}"))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        img, t, _ = self.samples[i]
        return img.astype(np.float32), t


class _SyntheticDepthPredictDatasetHP(_SyntheticDepthDatasetHP):
    def __getitem__(self, i):
        img, t, name = self.samples[i]
        return {"hp_imgs": img.astype(np.float32), "hp_masks": t, "names": name}


class _SyntheticDataModuleBase:
    """Shared datamodule plumbing: loaders, overfit subsets, data fraction."""

    def __init__(self, config, train_ds, val_ds, pred_ds):
        self.config = config
        self.common = config.common
        self.train_ds, self.val_ds, self.pred_ds = train_ds, val_ds, pred_ds

        n = len(train_ds)
        self.train_indices = np.arange(n)
        if self.common.training_data_fraction < 1.0:
            rng = np.random.RandomState(self.common.data_fraction_seed)
            k = max(1, int(round(n * self.common.training_data_fraction)))
            self.train_indices = rng.permutation(n)[:k]
        if self.common.manual_overfit_batches > 0:
            # identical indices across instantiations (reference hp_datasets.py:288-307)
            rng = np.random.RandomState(self.common.seed or 0)
            k = min(len(self.train_indices),
                    self.common.manual_overfit_batches * self.common.batch_size)
            self.train_indices = self.train_indices[rng.permutation(len(self.train_indices))[:k]]
        # the synthetic predict split mirrors VAL (train names never appear in it)
        self.pred_indices = None

    def train_dataloader(self):
        return DataLoader(
            self.train_ds,
            batch_size=self.common.batch_size,
            shuffle=self.common.shuffle,
            seed=self.common.seed or 0,
            drop_last=True,
            indices=self.train_indices,
            num_workers=self.common.train_worker,
        )

    def val_dataloader(self):
        return DataLoader(self.val_ds, batch_size=self.common.val_batch_size,
                          shuffle=False, num_workers=self.common.val_worker)

    def predict_dataloader(self):
        return DataLoader(self.pred_ds, batch_size=self.common.pred_batch_size,
                          shuffle=False, num_workers=self.common.val_worker)

    def get_classes(self):
        return N_CLASSES

    def get_class_names(self):
        return CLASS_NAMES

    def get_img_features(self):
        return 3

    def get_img_dims(self):
        return self.base_pix * self.nside ** 2

    def get_pred_writer(self, writer_name, **kwargs):
        raise NotImplementedError(
            f"prediction writer {writer_name!r}: the synthetic datamodules' writers come "
            "with the port's segmentation evaluation (ROADMAP queue 1 item 4)")


class SyntheticHPSegDataModule(_SyntheticDataModuleBase):
    def __init__(self, config):
        c = config.common
        nside, bp = config.input_nside, config.input_base_pix
        seed = c.seed or 42
        super().__init__(
            config,
            _SyntheticSegDatasetHP(nside, bp, c.synthetic_train_samples, seed),
            _SyntheticSegDatasetHP(nside, bp, c.synthetic_val_samples, seed + 10_000),
            _SyntheticSegPredictDatasetHP(nside, bp, min(c.synthetic_val_samples, 4),
                                          seed + 10_000),
        )
        self.nside, self.base_pix = nside, bp


class SyntheticHPDepthDataModule(_SyntheticDataModuleBase):
    def __init__(self, config):
        c = config.common
        dc = config.common_depth
        nside, bp = config.input_nside, config.input_base_pix
        seed = c.seed or 42
        super().__init__(
            config,
            _SyntheticDepthDatasetHP(nside, bp, c.synthetic_train_samples, seed, dc),
            _SyntheticDepthDatasetHP(nside, bp, c.synthetic_val_samples, seed + 10_000, dc),
            _SyntheticDepthPredictDatasetHP(nside, bp, min(c.synthetic_val_samples, 4),
                                            seed + 10_000, dc),
        )
        self.nside, self.base_pix = nside, bp

    def get_classes(self):
        return 1
