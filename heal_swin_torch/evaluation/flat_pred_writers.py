"""Flat segmentation prediction writers (the port's copy of
``heal_swin_tpu/evaluation/flat_pred_writers.py``; reference
``heal_swin/evaluation/flat_pred_writers.py``): the base writer's overlay grids, the
best/worst writer, the paper's headline flat metric ``hp_masked_iou`` (whose per-
calibration plumbing the HEALPix headline writer inherits) and ``val_on_hp_projected``,
the flat predictions scored on the HEALPix grid against the HP masks.  The grids go
through ``utils/overlay.py`` and ``utils/image.resize_bilinear``.

Writer protocol (driven by ``Trainer.predict``): ``write_on_batch_end(preds, batch,
batch_idx)`` + ``on_predict_epoch_end()``; metrics are logged to the tracking run passed
as ``run``; best/worst writers re-predict via ``set_predict_fn``.  All of it is host
numpy."""

from __future__ import annotations

import os
import pickle
import re
from functools import partial
from string import Template

import numpy as np

from heal_swin_torch.evaluation import seg_metrics_np as m
from heal_swin_torch.projection import fisheye
from heal_swin_torch.utils import image as I
from heal_swin_torch.utils import overlay as ov
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


class WoodscapeFlatBasePredictionWriter(_WriterBase):
    """Per-sample overlay grids with IoU in filename (reference :20-87)."""

    def __init__(self, output_dir=None, output_resolution=1.0, prefix="", f_out=10,
                 part="val", woodscape_version=None, run=None, **kwargs):
        super().__init__(run=run)
        self.output_dir = output_dir
        self.resolution = output_resolution
        self.part = part
        self.f_out = f_out
        self.woodscape_version = woodscape_version
        self.prefix = _norm_prefix(prefix)

    def write_on_batch_end(self, preds, batch, batch_idx):
        for transf_img, transf_mask, pred, img, mask, name in zip(
            batch["s2_imgs"], batch["s2_masks"], preds, batch["imgs"], batch["masks"],
            batch["names"],
        ):
            transf_img_cf = np.asarray(transf_img).transpose(2, 0, 1)  # channels-first
            pred_overlay = ov.get_overlay(self.woodscape_version, pred, transf_img_cf, 1)
            gt_overlay = ov.get_overlay(self.woodscape_version, mask, img, 1)
            out_size = tuple(int(d * self.resolution) for d in gt_overlay.shape[-2:])
            gt_overlay = I.resize_bilinear(gt_overlay, out_size)
            pred_overlay_r = I.resize_bilinear(pred_overlay, out_size)
            img_r = I.resize_bilinear(np.asarray(img), out_size)
            diff = (
                I.resize_bilinear(pred[None].astype(np.uint8), out_size)
                == I.resize_bilinear(np.asarray(mask)[None].astype(np.uint8), out_size)
            )
            diff = (255 * diff.astype(np.uint8)).repeat(3, axis=0)
            iou = m.iou_functional(pred, transf_mask, self.f_out)
            path = os.path.join(
                self.output_dir, f"{self.prefix}{self.part}_{name}_best_ckpt_iou={iou:.4f}.png"
            )
            ov.save_image_grid([img_r, diff, gt_overlay, pred_overlay_r], path, nrow=2)


class WoodscapeFlatBestWorstPredictionWriter(_WriterBase):
    """Rank samples by a metric, re-predict and save top/bottom-k (reference :90-202)."""

    def __init__(self, output_dir=None, output_resolution=1.0, f_out=10, prefix="",
                 part="val", top_k=5, ranking_metric="iou_ignored", sort_dir="asc",
                 pred_dataset=None, woodscape_version=None, run=None, input_key="s2_imgs",
                 target_key="s2_masks", **kwargs):
        super().__init__(run=run)
        self.output_dir = output_dir
        self.resolution = output_resolution
        self.part = part
        self.top_k = top_k
        self.pred_dataset = pred_dataset
        self.woodscape_version = woodscape_version
        self.input_key = input_key
        self.target_key = target_key
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
        for pred, target, name in zip(preds, batch[self.target_key], batch["names"]):
            self.metric_values.append(self.ranking_metric(pred, target))
            self.names.append(name)

    def _save_sample(self, sample, pred, metric_value, top_bottom, idx, name):
        transf_img_cf = np.asarray(sample["s2_imgs"]).transpose(2, 0, 1)
        pred_overlay = ov.get_overlay(self.woodscape_version, pred, transf_img_cf, 0.7)
        gt_overlay = ov.get_overlay(
            self.woodscape_version, sample["masks"], sample["imgs"], 0.7
        )
        fname = (
            f"{self.prefix}{self.part}_{top_bottom}_{idx + 1}_{name}"
            f"_{self.metric_name}={metric_value:.4f}.png"
        )
        ov.save_image_grid([gt_overlay, pred_overlay], os.path.join(self.output_dir, fname))

    def on_predict_epoch_end(self):
        values = np.array(self.metric_values)
        names = np.array(self.names)
        order = np.argsort(values)
        if self.sort_dir == "desc":
            order = order[::-1]
        pred_names = {"top": names[order[-self.top_k:]][::-1], "bottom": names[order[: self.top_k]]}
        lookup = {s: i for i, s in enumerate(names)}
        for top_bottom, group in pred_names.items():
            for idx, name in enumerate(group):
                # find the sample in the predict dataset by name
                sample = None
                for si in range(len(self.pred_dataset)):
                    s = self.pred_dataset[si]
                    if s["names"] == name:
                        sample = s
                        break
                if sample is None or self._predict_fn is None:
                    continue
                pred = self._predict_fn(np.asarray(sample[self.input_key])[None])[0]
                metric_value = self.ranking_metric(pred, sample[self.target_key])
                self._save_sample(sample, pred, metric_value, top_bottom, idx, name)


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


class WoodscapeFlatValOnHPProjectedPredictionWriter(_WriterBase):
    """Project flat predictions onto the HP grid and score against hp_masks
    (reference :321-421) -> metrics *_acc/iou[_ignored]_projected_to_hp."""

    def __init__(self, output_dir=None, part="", prefix="", rotate_pole=False, f_out=10,
                 nside=256, base_pix=8, s2_bkgd_class=0, orig_size=None,
                 padding=(0, 0, 0, 0), run=None, **_ignore):
        super().__init__(run=run)
        self.rotate_pole = rotate_pole
        self.f_out = f_out
        self.nside = nside
        self.base_pix = base_pix
        self.s2_bkgd_class = s2_bkgd_class
        self.part = part
        self.orig_size = orig_size
        self.padding = padding
        self.acc = m.Accuracy()
        self.acc_ignored = m.Accuracy(ignore_index=0)
        self.iou = m.IoU(num_classes=f_out, reduction="none")
        self.prefix = _norm_prefix(prefix)
        self.theta, self.phi = fisheye.hp_grid_angles(nside, base_pix)

    def _undo_transforms(self, pred):
        left, top, right, bottom = self.padding
        if any(self.padding):
            H, W = pred.shape[-2:]
            pred = pred[..., top : H - bottom or None, left : W - right or None]
        if self.orig_size is not None:
            pred = I.resize_nearest(pred, tuple(self.orig_size))
        return pred

    def write_on_batch_end(self, preds, batch, batch_idx):
        hp_preds = []
        for idx, (flat_pred, cal_info) in enumerate(zip(preds, batch["cal_infos"])):
            flat_pred = self._undo_transforms(np.asarray(flat_pred))
            u, v = fisheye.project_s2_points_to_img(
                self.theta, self.phi, cal_info, self.rotate_pole
            )
            pred = fisheye.sample_mask(flat_pred, v, u, s2_bkgd_class=self.s2_bkgd_class)
            hp_preds.append(pred)
            mask = np.asarray(batch["hp_masks"][idx])
            self.acc.update(pred, mask)
            self.acc_ignored.update(pred, mask)
            self.iou.update(pred, mask)
        return np.stack(hp_preds), batch["hp_masks"]

    def on_predict_epoch_end(self):
        pref = f"{self.prefix}{self.part}"
        ious = self.iou.compute()
        self.log_metrics(
            {
                f"{pref}_acc_projected_to_hp": self.acc.compute(),
                f"{pref}_acc_ignored_projected_to_hp": self.acc_ignored.compute(),
                f"{pref}_iou_projected_to_hp": float(np.mean(ious)),
                f"{pref}_iou_ignored_projected_to_hp": float(np.mean(ious[1:])),
            }
        )
