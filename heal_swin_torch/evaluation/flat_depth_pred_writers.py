"""The flat depth evaluation writers that draw nothing (counterparts of
``WoodscapeFlatDepthValOnHPProjectedPredictionWriter`` and
``WoodscapeFlatDepthChamferDistBestWorstPredictionWriter`` in
``heal_swin_tpu/evaluation/flat_depth_pred_writers.py``; reference
``heal_swin/evaluation/flat_depth_pred_writers.py``).  The base and best/worst writers
and the Chamfer writer's plots draw with matplotlib and wait for a way to draw without
it (ROADMAP queue 1 item 8).

Predictions arrive channels-last (B, H, W, C) with channel 0 in metric depths, as
``WoodscapeDepthSwin.predict`` returns them.  ``val_on_hp_projected`` samples the flat
predictions on the HEALPix grid (nearest pixel, nan outside the image) and scores them
against the HP depth targets in metric space: {mse,SILogE,iRMSE,RelAE,RelSE}_projected_to_hp.
The Chamfer writer scores every sample on the HEALPix writer's four point-cloud variants,
flat on both sides: chamfer_distance (prediction vs the resized target),
chamfer_distance_full_res (vs the full-resolution target), and the two hp_masked
variants, which cut both the prediction and the target to the HEALPix footprint.  The
prediction's cutout is built once a sample (the JAX writer builds it once a variant; the
clouds are the same).
"""

from __future__ import annotations

import numpy as np
import torch

from heal_swin_torch.data import normalize_depth_data as ndd
from heal_swin_torch.evaluation import depth_metrics_np as dm
from heal_swin_torch.evaluation.flat_pred_writers import _norm_prefix, _WriterBase
from heal_swin_torch.evaluation.hp_depth_pred_writers import (
    METRICS,
    SMALL_RES,
    WoodscapeHPDepthChamferDistBestWorstPredictionWriter,
    _DepthMetricDict,
    _resize_float,
)
from heal_swin_torch.projection import fisheye
from heal_swin_torch.utils import depth_utils
from heal_swin_torch.utils import image as I


def _cf(preds):
    """(B, H, W, C) -> (B, C, H, W) numpy (a tensor on any device)."""
    p = preds.detach().cpu().numpy() if isinstance(preds, torch.Tensor) else np.asarray(preds)
    return p.transpose(0, 3, 1, 2) if p.ndim == 4 else p[:, None]


class WoodscapeFlatDepthValOnHPProjectedPredictionWriter(_WriterBase):
    """Project flat depth predictions onto the HP grid, score against the HP depth
    targets in metric space -> {metric}_projected_to_hp (reference :120-253).

    As in the JAX writer, the HP targets are taken back to metric space once (the
    reference re-applies transform_and_normalize to them, a double transform that is
    the identity only in the default None/None config)."""

    def __init__(self, output_dir=None, part="val", prefix="", rotate_pole=False,
                 nside=256, base_pix=8, orig_size=None, padding=(0, 0, 0, 0),
                 data_transform=None, mask_background=False, normalize_data=None,
                 run=None, **_ignore):
        super().__init__(run=run)
        self.rotate_pole = rotate_pole
        self.nside = nside
        self.base_pix = base_pix
        self.part = part
        self.orig_size = orig_size
        self.padding = padding
        self.data_transform = data_transform
        self.mask_background = mask_background
        self.normalize_data = normalize_data
        self.stats = ndd.get_depth_data_stats(data_transform, mask_background)
        self.metric_dict = _DepthMetricDict(data_transform, mask_background)
        self.prefix = _norm_prefix(prefix)
        self.theta, self.phi = fisheye.hp_grid_angles(nside, base_pix)

    def _undo_transforms(self, pred):
        left, top, right, bottom = self.padding
        if any(self.padding):
            H, W = pred.shape[-2:]
            pred = pred[..., top : H - bottom or None, left : W - right or None]
        if self.orig_size is not None and tuple(self.orig_size) != pred.shape[-2:]:
            pred = I.resize_nearest(pred, tuple(self.orig_size))
        return pred

    def write_on_batch_end(self, preds, batch, batch_idx):
        preds_cf = _cf(preds)
        hp_preds = []
        for pred, hp_mask, cal_info in zip(preds_cf, batch["hp_masks"], batch["cal_infos"]):
            flat_pred = self._undo_transforms(pred[0])
            u, v = fisheye.project_s2_points_to_img(
                self.theta, self.phi, cal_info, self.rotate_pole
            )
            # nearest sampling with nan background (the depth variant of sample_mask
            # keeps float32, project_depth_on_s2.py:80-85)
            u_int = np.around(v, 0).astype(int)
            v_int = np.around(u, 0).astype(int)
            inb = (
                (0 <= u_int) & (u_int < flat_pred.shape[0])
                & (0 <= v_int) & (v_int < flat_pred.shape[1])
            )
            hp_pred = np.full(u.shape, np.nan)
            hp_pred[inb] = flat_pred[u_int[inb], v_int[inb]]
            hp_preds.append(hp_pred)
            hp_mask_metric = np.asarray(
                ndd.unnormalize_and_retransform(
                    np.asarray(hp_mask), self.normalize_data, self.stats, self.data_transform
                )
            )
            self.metric_dict.update(hp_pred[None, None], hp_mask_metric[None])
        return np.stack(hp_preds), batch["hp_masks"]

    def on_predict_epoch_end(self):
        pref = f"{self.prefix}{self.part}"
        self.log_metrics(self.metric_dict.computed(pref, "projected_to_hp"))


class WoodscapeFlatDepthChamferDistBestWorstPredictionWriter(
        WoodscapeHPDepthChamferDistBestWorstPredictionWriter):
    """The Chamfer evaluation of the flat model (reference :463-905): the HEALPix
    writer's folds, host/device pipeline, ranking and ``on_pair`` hook, on flat clouds
    (``variants``).  ``device`` and ``chamfer_route`` as in the HEALPix writer."""

    target_key = "s2_masks"
    channels_first = staticmethod(_cf)

    def variants(self, pred, s2_mask, cal_info, full_res_mask):
        """The four variants of one sample: (metric name, builder of its (p, q) clouds)
        in the writer's order.  ``pred`` (C, H, W) metric depths, ``s2_mask`` (H, W) the
        network-space target at the model's size, ``full_res_mask`` the metric target at
        the original size."""
        target = np.asarray(
            ndd.unnormalize_and_retransform(
                np.asarray(s2_mask), self.normalize_data, self.stats, self.data_transform
            )
        ).copy()
        target[np.isinf(target)] = np.nan
        pred = np.asarray(pred)
        pred_b, target_b = pred[None], target[None]
        full_res_mask = np.asarray(full_res_mask, dtype=np.float64)[None]
        fg = self._foreground(target_b)
        full_fg = self._foreground(full_res_mask)
        kwargs = dict(nside=self.nside, base_pix=self.base_pix, rotate_pole=self.rotate_pole)
        masked_pred = []  # the prediction's HP cutout, built by the first variant needing it

        def hp_cutout(flat):
            return depth_utils.mask_flat_with_hp_cutout(
                flat.copy(), cal_info, base_pix=self.base_pix, nside=self.nside,
                rotate_pole=self.rotate_pole, masking_val=float("nan"))

        def vs_masked(masked):
            # the hp_masked variants also cut the prediction to the HP footprint
            # (reference :576-586, :615-625)
            if not masked_pred:
                masked_pred.append(hp_cutout(pred[0])[None, None])
            return dm.build_chamfer_clouds(masked_pred[0], masked, cal_info,
                                           hp_data=(False, False),
                                           foreground_pix=(fg, self._foreground(masked)),
                                           **kwargs)

        def native():
            return dm.build_chamfer_clouds(pred_b, target_b, cal_info, hp_data=False,
                                           foreground_pix=fg, **kwargs)

        def full():
            return dm.build_chamfer_clouds(pred_b, full_res_mask, cal_info,
                                           hp_data=(False, False),
                                           foreground_pix=(fg, full_fg), **kwargs)

        def full_masked():
            return vs_masked(hp_cutout(full_res_mask))

        def small_masked():
            return vs_masked(hp_cutout(_resize_float(full_res_mask, SMALL_RES,
                                                     self.interpolation_mode)))

        return list(zip(METRICS, (native, full, full_masked, small_masked)))
