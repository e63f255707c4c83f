"""Depth metrics of the evaluation writers (the port's counterpart of
``DepthMSE``, ``DepthRelSE``, ``DepthRelAE``, ``DepthiRMSE``,
``ScaleInvariantLogError``, ``build_chamfer_clouds`` and ``ChamferDistance`` in
``heal_swin_tpu/evaluation/depth_metrics_np.py``; reference
``heal_swin/evaluation/custom_metrics.py``).

The accumulators take preds (N, C, ...) (channel 0 the mean depth) and targets (N, ...)
and leave out non-finite pairs (reference get_non_inf_non_nan_idxs, :12-22); they are
host numpy.  Building the Chamfer clouds is host numpy; the distance runs on the
device through ``ops/chamfer.py`` (K10 or K11)."""

from __future__ import annotations

import numpy as np

from heal_swin_torch.ops.chamfer import chamfer_distance
from heal_swin_torch.utils import depth_utils


def _valid(a, b):
    return np.isfinite(a) & np.isfinite(b)


class DepthMSE:
    """reference custom_metrics.py:62-99."""

    def __init__(self):
        self.sum_se = 0.0
        self.n = 0.0

    def update(self, preds, target):
        means = np.asarray(preds)[:, 0, ...].squeeze()
        target = np.asarray(target).squeeze()
        assert means.shape == target.shape
        idxs = _valid(means, target)
        self.sum_se += float(np.sum((means[idxs] - target[idxs]) ** 2))
        self.n += float(idxs.sum())
        return self.sum_se / max(self.n, 1)

    __call__ = update

    def compute(self):
        return self.sum_se / max(self.n, 1)

    def reset(self):
        self.sum_se = 0.0
        self.n = 0.0


class DepthRelSE:
    """MSE relative to the dataset-mean predictor (reference :102-134)."""

    def __init__(self, total_mean):
        self.total_mean = total_mean
        self.sum_pred = 0.0
        self.sum_mean = 0.0

    def update(self, preds, target):
        means = np.asarray(preds)[:, 0, ...]
        target = np.asarray(target)
        idxs = _valid(means, np.broadcast_to(target, means.shape))
        t = np.broadcast_to(target, means.shape)[idxs]
        self.sum_pred += float(np.sum((means[idxs] - t) ** 2))
        self.sum_mean += float(np.sum((self.total_mean - t) ** 2))

    def compute(self):
        return self.sum_pred / max(self.sum_mean, 1e-12)


class DepthRelAE:
    """reference :137-167."""

    def __init__(self, total_mean):
        self.total_mean = total_mean
        self.sum_pred = 0.0
        self.sum_mean = 0.0

    def update(self, preds, target):
        means = np.asarray(preds)[:, 0, ...]
        target = np.asarray(target)
        idxs = _valid(means, np.broadcast_to(target, means.shape))
        t = np.broadcast_to(target, means.shape)[idxs]
        self.sum_pred += float(np.sum(np.abs(means[idxs] - t)))
        self.sum_mean += float(np.sum(np.abs(self.total_mean - t)))

    def compute(self):
        return self.sum_pred / max(self.sum_mean, 1e-12)


class DepthiRMSE:
    """Inverse-depth RMSE in 1/km (reference :170-205)."""

    def __init__(self):
        self.sum_inv_se = 0.0
        self.n = 0.0

    def update(self, preds, target):
        means = np.asarray(preds, dtype=np.float64)[:, 0, ...]
        target = np.asarray(target, dtype=np.float64)
        with np.errstate(divide="ignore"):
            inv_p = 1.0 / (0.001 * means)
            inv_t = 1.0 / (0.001 * np.broadcast_to(target, means.shape))
        idxs = _valid(inv_p, inv_t)
        self.sum_inv_se += float(np.sum((inv_p[idxs] - inv_t[idxs]) ** 2))
        self.n += float(idxs.sum())

    def compute(self):
        return float(np.sqrt(self.sum_inv_se / max(self.n, 1)))


class ScaleInvariantLogError:
    """KITTI SILog without sqrt (reference :429-468)."""

    def __init__(self):
        self.sum_d = 0.0
        self.sum_d2 = 0.0
        self.n = 0.0

    def update(self, preds, target):
        p = np.asarray(preds, dtype=np.float64)[:, 0, ...]
        t = np.broadcast_to(np.asarray(target, dtype=np.float64), p.shape)
        idxs = _valid(p, t) & (p > 0) & (t > 0)
        d = np.log(t[idxs]) - np.log(p[idxs])
        self.sum_d += float(d.sum())
        self.sum_d2 += float((d**2).sum())
        self.n += float(d.size)

    def compute(self):
        n = max(self.n, 1)
        return self.sum_d2 / n - (self.sum_d / n) ** 2


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
