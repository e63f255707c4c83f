"""The flat segmentation writers' base that the HEALPix headline writer inherits (the
port's copy of ``_norm_prefix``, ``_resize_nearest_torch``, ``_WriterBase``,
``WoodscapeFlatPerCalPredictionWriter``, ``HPMaskedIoU`` and
``WoodscapeFlatHPMaskedIoUPredictionWriter`` in
``heal_swin_tpu/evaluation/flat_pred_writers.py``; reference
``heal_swin/evaluation/flat_pred_writers.py``).  The writers that are only flat come
with the flat SWIN-UNet (ROADMAP queue 1 item 5).

Writer protocol (driven by ``Trainer.predict``): ``write_on_batch_end(preds, batch,
batch_idx)`` + ``on_predict_epoch_end()``; metrics are logged to the tracking run passed
as ``run``; best/worst writers re-predict via ``set_predict_fn``.  All of it is host
numpy."""

from __future__ import annotations

import os
import pickle
import re
from string import Template

import numpy as np

from heal_swin_torch.evaluation import seg_metrics_np as m
from heal_swin_torch.projection import fisheye
from heal_swin_torch.utils import image as I
from heal_swin_torch.utils.utils import get_datasets_path


def _norm_prefix(prefix):
    if prefix != "" and not prefix.endswith("_"):
        return prefix + "_"
    return prefix


def _resize_nearest_torch(mask, size):
    """torchvision Resize(size, NEAREST) semantics: int -> shorter side, tuple -> exact."""
    H, W = mask.shape[-2:]
    if isinstance(size, (int, np.integer)):
        if H <= W:
            size = (int(size), int(W * size / H))
        else:
            size = (int(H * size / W), int(size))
    if tuple(size) == (H, W):
        return mask
    return I.resize_nearest(mask, tuple(size))


class _WriterBase:
    """The writer protocol: ``write_on_batch_end(preds, batch, batch_idx)`` per batch
    and ``on_predict_epoch_end()``; metrics go to the tracking ``run`` when given,
    else to stdout."""

    def __init__(self, run=None, **_ignore):
        self.run = run
        self._predict_fn = None

    def set_predict_fn(self, fn):
        self._predict_fn = fn

    def log_metrics(self, metrics):
        if self.run is not None:
            self.run.log_metrics(metrics)
        else:
            print("writer metrics:", {k: round(v, 4) for k, v in metrics.items()})

    def on_predict_epoch_end(self):
        pass


class WoodscapeFlatPerCalPredictionWriter(_WriterBase):
    """Per-calibration-cluster metric plumbing (reference :212-253); clusters come from
    the {pos}_samples_by_cal_data.pickle files of generate_metadata."""

    def __init__(self, woodscape_version=None, run=None, **_ignore):
        super().__init__(run=run)
        self.woodscape_version = woodscape_version
        self.sample_lists = self.get_sample_lists()
        self.cam_pos_re = re.compile(r"^[0-9]{5,5}_(FV|RV|MVL|MVR)$")

    def get_sample_lists(self):
        path = Template(
            os.path.join(
                get_datasets_path() / self.woodscape_version,
                "${cam_pos}_samples_by_cal_data.pickle",
            )
        )
        sample_lists = {}
        for cam_pos in ["fv", "rv", "mvl", "mvr"]:
            p = path.substitute(cam_pos=cam_pos)
            if not os.path.isfile(p):
                from heal_swin_torch.data.segmentation import generate_metadata

                generate_metadata.gen_cal_distribution_data(self.woodscape_version)
            with open(p, "rb") as f:
                sample_lists[cam_pos] = pickle.load(f)
        return sample_lists

    def get_metric_key(self, file_name):
        cam = self.cam_pos_re.match(file_name)
        cam_pos = cam.group(1).lower()
        for idx, sl in enumerate(self.sample_lists[cam_pos]):
            if np.sum(np.asarray(sl["file_names"]) == file_name) > 0:
                return f"{cam_pos}_{idx}"
        raise AssertionError(f"{file_name} not found in calibration data")


class HPMaskedIoU:
    """IoU restricted to flat pixels covered by the used HEALPix base pixels
    (reference custom_metrics.py:25-59): back-project an all-zeros HP mask with
    background=1; the footprint is where the result is 0."""

    def __init__(self, cal_info, nside, base_pix, rotate_pole, proj_res, num_classes):
        hp_zeros = np.zeros(base_pix * nside**2, dtype=np.uint8)
        flat = fisheye.project_hp_mask_back(
            hp_zeros, cal_info, proj_res, rotate_pole, nside, base_pix, s2_bkgd_class=1
        )
        self.mask = flat == 0
        self.iou = m.IoU(num_classes=num_classes, reduction="none")

    def update(self, preds, target):
        self.iou.update(preds[..., self.mask], target[..., self.mask])

    def compute(self):
        return self.iou.compute()


class WoodscapeFlatHPMaskedIoUPredictionWriter(WoodscapeFlatPerCalPredictionWriter):
    """Paper headline flat metric: HP-footprint-masked IoU accumulated per calibration
    cluster, confusion matrices summed at epoch end (reference :256-318)."""

    METRIC_NAME = "hp_masked_iou"

    def __init__(self, output_dir=None, img_dims=None, f_out=10, rotate_pole=False,
                 base_pix=8, nside=256, part="val", prefix="", woodscape_version=None,
                 run=None, **_ignore):
        super().__init__(woodscape_version=woodscape_version, run=run)
        self.f_out = f_out
        # reference quirk: THIS writer (alone) uses the prefix verbatim — no
        # trailing-underscore normalization (reference flat_pred_writers.py:273 vs
        # the `prefix + "_"` of every other writer); metric names are pinned
        self.prefix = prefix
        self.part = part
        self.metrics = {}
        for cam_pos, lists in self.sample_lists.items():
            for i, sl in enumerate(lists):
                self.metrics[f"{cam_pos}_{i}"] = HPMaskedIoU(
                    cal_info=sl["cal_info"], nside=nside, base_pix=base_pix,
                    rotate_pole=rotate_pole, proj_res=img_dims, num_classes=f_out,
                )

    def write_on_batch_end(self, preds, batch, batch_idx):
        for pred, mask, name in zip(preds, batch["s2_masks"], batch["names"]):
            key = self.get_metric_key(name)
            self.metrics[key].update(np.asarray(pred)[None], np.asarray(mask)[None])

    def on_predict_epoch_end(self):
        confmat = np.zeros((self.f_out, self.f_out), dtype=np.int64)
        for metric in self.metrics.values():
            if metric.iou.confmat.sum() > 0:
                confmat += metric.iou.confmat
        ious = m.iou_from_confmat(confmat)
        self.log_metrics({f"{self.prefix}{self.part}_{self.METRIC_NAME}": float(np.mean(ious))})
