"""HEALPix segmentation prediction writers (the port's copy of
``heal_swin_tpu/evaluation/hp_pred_writers.py``; reference
heal_swin/evaluation/hp_pred_writers.py).

Host numpy: back-projection uses the closed-form inverse fisheye model through the
projection module, metric semantics match the reference exactly (metric names
enumerated in SURVEY.md §5.5), and the overlay grids go through the port's PNG codec.
Predictions arrive as numpy from ``Trainer.predict``."""

from __future__ import annotations

import os
from functools import partial

import numpy as np

from heal_swin_torch.evaluation import seg_metrics_np as m
from heal_swin_torch.evaluation.flat_pred_writers import (
    WoodscapeFlatHPMaskedIoUPredictionWriter,
    _WriterBase,
    _norm_prefix,
    _resize_nearest_torch,
)
from heal_swin_torch.projection import fisheye
from heal_swin_torch.utils import image as I
from heal_swin_torch.utils import overlay as ov


class WoodscapeHPBasePredictionWriter(_WriterBase):
    """Back-project hp image + prediction to flat, save overlay pairs with IoU in
    filename (reference :20-107)."""

    def __init__(self, output_dir=None, output_resolution=1, rotate_pole=False, f_out=10,
                 prefix="", nside=256, base_pix=8, s2_bkgd_class=0, part="val",
                 woodscape_version=None, run=None, **kwargs):
        super().__init__(run=run)
        self.output_dir = output_dir
        self.resolution = output_resolution
        self.rotate_pole = rotate_pole
        self.nside = nside
        self.base_pix = base_pix
        self.s2_bkgd_class = s2_bkgd_class
        self.part = part
        self.f_out = f_out
        self.woodscape_version = woodscape_version
        self.prefix = _norm_prefix(prefix)

    def write_on_batch_end(self, preds, batch, batch_idx):
        for hp_img, hp_pred, hp_mask, img, mask, cal_info, name in zip(
            batch["hp_imgs"], preds, batch["hp_masks"], batch["imgs"], batch["masks"],
            batch["cal_infos"], batch["names"],
        ):
            hp_img_cf = np.asarray(hp_img)
            if hp_img_cf.ndim == 2 and hp_img_cf.shape[-1] == 3:  # channels-last input
                hp_img_cf = hp_img_cf.T
            img_new = fisheye.project_hp_img_back(
                hp_img_cf, cal_info, self.resolution, self.rotate_pole, self.base_pix
            )
            pred = fisheye.project_hp_mask_back(
                np.asarray(hp_pred), cal_info, self.resolution, self.rotate_pole,
                self.nside, self.base_pix, self.s2_bkgd_class,
            )
            pred_overlay = ov.get_overlay(self.woodscape_version, pred, img_new, 0.7)
            gt_overlay = ov.get_overlay(self.woodscape_version, mask, img, 0.7)
            gt_overlay = I.resize_bilinear(gt_overlay, pred_overlay.shape[-2:])
            ious = m.iou_functional(
                hp_pred, hp_mask, self.f_out, absent_score=np.nan, reduction="none"
            )
            iou = m.nanmean(ious)
            path = os.path.join(
                self.output_dir, f"{self.prefix}{self.part}_{name}_iou={iou:.4f}.png"
            )
            ov.save_image_grid([gt_overlay, pred_overlay], path, nrow=2)


class WoodscapeHPValOnBackProjectedPredictionWriter(_WriterBase):
    """Back-project HP predictions at proj_res and score against resized flat masks
    (reference :110-223) -> *_acc/iou[_ignored]_back_projected[_res_*]."""

    def __init__(self, output_dir=None, img_dims=None, rotate_pole=False, f_out=10,
                 prefix="", nside=256, base_pix=8, s2_bkgd_class=0, part="val",
                 woodscape_version=None, proj_res=1.0, run=None, **_ignore):
        super().__init__(run=run)
        self.rotate_pole = rotate_pole
        self.f_out = f_out
        self.nside = nside
        self.base_pix = base_pix
        self.s2_bkgd_class = s2_bkgd_class
        self.part = part
        self.proj_res = tuple(proj_res) if isinstance(proj_res, list) else proj_res
        self.org_size = None
        self.acc = m.Accuracy()
        self.acc_ignored = m.Accuracy(ignore_index=0)
        self.iou = m.IoU(num_classes=f_out, reduction="none")
        self.prefix = _norm_prefix(prefix)

    def write_on_batch_end(self, preds, batch, batch_idx):
        masks = _resize_nearest_torch(np.asarray(batch["masks"]), self.proj_res)
        cal_infos = batch["cal_infos"]
        if self.org_size is None:
            cal = cal_infos[0]["intrinsic"]
            self.org_size = (int(cal["height"]), int(cal["width"]))
        flat_preds = []
        for idx, (hp_pred, cal_info) in enumerate(zip(preds, cal_infos)):
            pred = fisheye.project_hp_mask_back(
                np.asarray(hp_pred), cal_info, output_resolution=self.proj_res,
                rotate_pole=self.rotate_pole, nside=self.nside, base_pix=self.base_pix,
                s2_bkgd_class=self.s2_bkgd_class,
            )
            flat_preds.append(pred)
            self.acc.update(pred, masks[idx])
            self.acc_ignored.update(pred, masks[idx])
            self.iou.update(pred, masks[idx])
        return np.stack(flat_preds), masks

    def get_res_suff(self):
        if isinstance(self.proj_res, int) and self.proj_res != min(self.org_size):
            return f"_res_{self.proj_res}"
        if isinstance(self.proj_res, tuple):
            return f"_res_{self.proj_res[0]}_{self.proj_res[1]}"
        return ""

    def on_predict_epoch_end(self):
        pref = f"{self.prefix}{self.part}"
        suff = "back_projected" + self.get_res_suff()
        ious = self.iou.compute()
        self.log_metrics(
            {
                f"{pref}_acc_{suff}": self.acc.compute(),
                f"{pref}_acc_ignored_{suff}": self.acc_ignored.compute(),
                f"{pref}_iou_{suff}": float(np.mean(ious)),
                f"{pref}_iou_ignored_{suff}": float(np.mean(ious[1:])),
            }
        )


class WoodscapeHPBestWorstPredictionWriter(_WriterBase):
    """Rank by per-sample metric, re-predict and save back-projected top/bottom-k
    (reference :226-364)."""

    def __init__(self, output_dir=None, output_resolution=1, rotate_pole=False, f_out=10,
                 prefix="", nside=256, base_pix=8, s2_bkgd_class=0, part="val", top_k=5,
                 ranking_metric="iou_ignored", sort_dir="asc", pred_dataset=None,
                 woodscape_version=None, run=None, **_ignore):
        super().__init__(run=run)
        self.output_dir = output_dir
        self.resolution = output_resolution
        self.rotate_pole = rotate_pole
        self.nside = nside
        self.base_pix = base_pix
        self.s2_bkgd_class = s2_bkgd_class
        self.part = part
        self.top_k = top_k
        self.pred_dataset = pred_dataset
        self.woodscape_version = woodscape_version
        metrics = {
            "acc": m.accuracy_functional,
            "iou": partial(self._iou, num_classes=f_out),
            "acc_ignored": partial(m.accuracy_functional, ignore_index=0),
            "iou_ignored": partial(self._iou, num_classes=f_out, ignore=True),
        }
        assert ranking_metric in metrics
        self.ranking_metric = metrics[ranking_metric]
        self.metric_name = ranking_metric
        assert sort_dir in ["asc", "desc"]
        self.sort_dir = sort_dir
        self.metric_values = []
        self.names = []
        self.prefix = _norm_prefix(prefix)

    @staticmethod
    def _iou(preds, targets, num_classes, ignore=False):
        ious = m.iou_functional(preds, targets, num_classes, absent_score=np.nan,
                                reduction="none")
        if ignore:
            ious = ious[1:]
        return m.nanmean(ious)

    def write_on_batch_end(self, preds, batch, batch_idx):
        for hp_pred, hp_mask, name in zip(preds, batch["hp_masks"], batch["names"]):
            self.metric_values.append(self.ranking_metric(hp_pred, hp_mask))
            self.names.append(name)

    def on_predict_epoch_end(self):
        values = np.array(self.metric_values)
        names = np.array(self.names)
        order = np.argsort(values)
        if self.sort_dir == "desc":
            order = order[::-1]
        pred_names = {"top": names[order[-self.top_k:]][::-1], "bottom": names[order[: self.top_k]]}
        for top_bottom, group in pred_names.items():
            print(f"writing predictions of {top_bottom} {self.top_k} samples...")
            for idx, name in enumerate(group):
                sample = None
                for si in range(len(self.pred_dataset)):
                    s = self.pred_dataset[si]
                    if s["names"] == name:
                        sample = s
                        break
                if sample is None or self._predict_fn is None:
                    continue
                hp_pred = self._predict_fn(np.asarray(sample["hp_imgs"])[None])[0]
                metric_value = self.ranking_metric(hp_pred, sample["hp_masks"])
                hp_img_cf = np.asarray(sample["hp_imgs"])
                if hp_img_cf.ndim == 2 and hp_img_cf.shape[-1] == 3:
                    hp_img_cf = hp_img_cf.T
                img_new = fisheye.project_hp_img_back(
                    hp_img_cf, sample["cal_infos"], self.resolution, self.rotate_pole,
                    self.base_pix,
                )
                pred = fisheye.project_hp_mask_back(
                    np.asarray(hp_pred), sample["cal_infos"], self.resolution,
                    self.rotate_pole, self.nside, self.base_pix, self.s2_bkgd_class,
                )
                pred_overlay = ov.get_overlay(self.woodscape_version, pred, img_new, 0.7)
                gt_overlay = ov.get_overlay(
                    self.woodscape_version, sample["masks"], sample["imgs"], 0.7
                )
                gt_overlay = I.resize_bilinear(gt_overlay, pred_overlay.shape[-2:])
                fname = (
                    f"{self.prefix}{self.part}_{top_bottom}_{idx + 1}_{name}"
                    f"_{self.metric_name}={metric_value:.4f}.png"
                )
                ov.save_image_grid(
                    [gt_overlay, pred_overlay], os.path.join(self.output_dir, fname)
                )


class WoodscapeHPBackProjectedHPMaskedIoUPredictionWriter(WoodscapeFlatHPMaskedIoUPredictionWriter):
    """Compose back-projection with the flat HP-masked IoU — the paper's headline flat
    metric for HEAL-SWIN: back_projected_hp_masked_iou[_res_*] (reference :367-448)."""

    METRIC_NAME = "back_projected_hp_masked_iou"

    def __init__(self, output_dir=None, img_dims=None, part="", prefix="",
                 rotate_pole=False, f_out=10, nside=256, base_pix=8, s2_bkgd_class=0,
                 orig_size=None, padding=(0, 0, 0, 0), woodscape_version=None,
                 proj_res=1.0, run=None, **_ignore):
        super().__init__(
            output_dir=output_dir, img_dims=proj_res, f_out=f_out, rotate_pole=rotate_pole,
            base_pix=base_pix, nside=nside, part=part, prefix=prefix,
            woodscape_version=woodscape_version, run=run,
        )
        self.proj_pred_writer = WoodscapeHPValOnBackProjectedPredictionWriter(
            output_dir=output_dir, img_dims=img_dims, rotate_pole=rotate_pole, f_out=f_out,
            prefix=prefix, nside=nside, base_pix=base_pix, s2_bkgd_class=s2_bkgd_class,
            part=part, woodscape_version=woodscape_version, proj_res=proj_res, run=run,
        )
        self.proj_res = self.proj_pred_writer.proj_res
        self._suffix_applied = False

    def write_on_batch_end(self, preds, batch, batch_idx):
        flat_preds, flat_masks = self.proj_pred_writer.write_on_batch_end(
            preds, batch, batch_idx
        )
        if not self._suffix_applied:
            self.METRIC_NAME = self.METRIC_NAME + self.proj_pred_writer.get_res_suff()
            self._suffix_applied = True
        flat_masks = _resize_nearest_torch(np.asarray(flat_masks), self.proj_res)
        flat_batch = {"s2_masks": flat_masks, "names": batch["names"]}
        super().write_on_batch_end(flat_preds, flat_batch, batch_idx)

    def on_predict_epoch_end(self):
        self.proj_pred_writer.on_predict_epoch_end()
        super().on_predict_epoch_end()
