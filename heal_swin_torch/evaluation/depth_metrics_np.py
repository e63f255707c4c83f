"""The Chamfer depth metric on point clouds (the port's counterpart of
``build_chamfer_clouds`` and ``ChamferDistance`` in
``heal_swin_tpu/evaluation/depth_metrics_np.py``; reference
``heal_swin/evaluation/custom_metrics.py:471-577``).

Building the clouds is host numpy; the distance runs on the device through
``ops/chamfer.py`` (K10 or K11)."""

from __future__ import annotations

import numpy as np

from heal_swin_torch.ops.chamfer import chamfer_distance
from heal_swin_torch.utils import depth_utils


def build_chamfer_clouds(preds, target, cal_info, nside=256, base_pix=8, hp_data=False,
                         rotate_pole=False, foreground_pix=None):
    """The (p, q) point clouds of a prediction (N, C, ...) (channel 0) and a target
    depth map: depths times ray directions (flat calibration inverse-projection or HP
    pixel centres), rotated by the extrinsic quaternion, the non-finite and (with
    ``foreground_pix``) background points dropped.  Pure numpy, so a writer can build
    the next variant's clouds in a worker thread while the device folds this one's."""
    if isinstance(hp_data, (list, tuple)):
        hp_pred, hp_target = hp_data
    else:
        hp_pred = hp_target = hp_data
    pred_dist = np.asarray(preds)[:, 0, ...]
    target = np.asarray(target)

    pred_pc, _ = depth_utils.create_point_cloud_from_depth_mask(
        pred_dist, cal_info, nside=nside, base_pix=base_pix, hp_data=hp_pred,
        rotate_pole=rotate_pole,
    )
    target_pc, _ = depth_utils.create_point_cloud_from_depth_mask(
        target, cal_info, nside=nside, base_pix=base_pix, hp_data=hp_target,
        rotate_pole=rotate_pole,
    )

    def _finite_rows(pc):
        return np.isfinite(pc.sum(axis=-1)).reshape(-1)

    pred_ok = _finite_rows(pred_pc)
    target_ok = _finite_rows(target_pc)

    if isinstance(foreground_pix, (list, tuple)):
        fp, ft = foreground_pix
        if fp is not None:
            pred_ok &= np.asarray(fp).reshape(-1)
        if ft is not None:
            target_ok &= np.asarray(ft).reshape(-1)
    elif foreground_pix is not None:
        fg = np.asarray(foreground_pix).reshape(-1)
        pred_ok &= fg
        target_ok &= fg

    p = pred_pc.reshape(-1, 3)[pred_ok]
    q = target_pc.reshape(-1, 3)[target_ok]
    return p, q


class ChamferDistance:
    """Point-cloud Chamfer metric: the mean over samples of the symmetric Chamfer
    distance (a sample whose distance is NaN, an empty side, is left out).

    ``update`` builds the clouds and accumulates; ``update_clouds`` takes built
    clouds (and optionally a ``chamfer.prepare_pair`` result); both return the
    sample's value.  ``device`` and ``route`` go to ``ops.chamfer.chamfer_distance``."""

    def __init__(self, device=None, route=None):
        self.sum_chamfer = 0.0
        self.num_samples = 0.0
        self.device = device
        self.route = route

    def update(self, preds, target, cal_info, nside=256, base_pix=8, hp_data=False,
               rotate_pole=False, foreground_pix=None):
        p, q = build_chamfer_clouds(
            preds, target, cal_info, nside=nside, base_pix=base_pix, hp_data=hp_data,
            rotate_pole=rotate_pole, foreground_pix=foreground_pix,
        )
        return self.update_clouds(p, q)

    def update_clouds(self, p, q, prepared=None, stats=None):
        loss = chamfer_distance(p, q, prepared=prepared, route=self.route, device=self.device,
                                stats=stats)
        if np.isfinite(loss):
            self.sum_chamfer += loss
            self.num_samples += 1
        return loss

    __call__ = update

    def compute(self):
        return self.sum_chamfer / max(self.num_samples, 1)
