"""The HEALPix depth Chamfer evaluation writer (counterpart of
``WoodscapeHPDepthChamferDistBestWorstPredictionWriter`` in
``heal_swin_tpu/evaluation/hp_depth_pred_writers.py``; reference
``heal_swin/evaluation/hp_depth_pred_writers.py:734-1225``).

Predictions arrive channels-last (B, npix, C) with channel 0 in metric depths, as
``WoodscapeDepthSwinHP.predict`` returns them.  The writer scores every sample on four
point-cloud variants and logs their means under the reference's names:
chamfer_distance (HP prediction vs HP target), chamfer_distance_full_res (vs the
full-resolution flat target), chamfer_distance_full_res_hp_masked (vs that target cut
to the HEALPix footprint: the paper's headline depth metric) and
chamfer_distance_small_res_hp_masked (the same at 629 x 834).  The host work of a
variant (cutouts, resizes, clouds, the pruned route's Morton prep) runs in a worker
thread one variant ahead of the device folds of the current one; the worker issues no
CUDA work.  The re-predict-and-plot half of the JAX writer is not ported yet.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from heal_swin_torch.data import normalize_depth_data as ndd
from heal_swin_torch.evaluation import depth_metrics_np as dm
from heal_swin_torch.ops import chamfer as chamfer_ops
from heal_swin_torch.ops import chamfer_pruned
from heal_swin_torch.ops._dispatch import default_device
from heal_swin_torch.utils import depth_utils
from heal_swin_torch.utils import image as I

SMALL_RES = (629, 834)  # reference hp_depth_pred_writers.py:806-810
BACKGROUND = (float("nan"), float("inf"), 1000)  # depth values that mark background
METRICS = ("chamfer_distance", "chamfer_distance_full_res",
           "chamfer_distance_full_res_hp_masked", "chamfer_distance_small_res_hp_masked")


def _norm_prefix(prefix):
    if prefix != "" and not prefix.endswith("_"):
        return prefix + "_"
    return prefix


class _WriterBase:
    """The writer protocol: ``write_on_batch_end(preds, batch, batch_idx)`` per batch
    and ``on_predict_epoch_end()``; metrics go to the tracking ``run`` when given,
    else to stdout."""

    def __init__(self, run=None, **_ignore):
        self.run = run

    def log_metrics(self, metrics):
        if self.run is not None:
            self.run.log_metrics(metrics)
        else:
            print("writer metrics:", {k: round(v, 4) for k, v in metrics.items()})

    def on_predict_epoch_end(self):
        pass


def _cf(preds):
    """(B, npix, C) -> (B, C, npix) numpy (a tensor on any device)."""
    p = preds.detach().cpu().numpy() if isinstance(preds, torch.Tensor) else np.asarray(preds)
    return p.transpose(0, 2, 1) if p.ndim == 3 else p[:, None, :]


def _resize_float(x, size, mode="nearest"):
    if isinstance(size, (int, float)):
        short = min(x.shape[-2:])
        scale = size if isinstance(size, float) else size / short
        size = (int(x.shape[-2] * scale), int(x.shape[-1] * scale))
    if tuple(size) == x.shape[-2:]:
        return x
    if mode == "nearest":
        return I.resize_nearest(x, tuple(size))
    return I.resize_bilinear(x, tuple(size))


def _rank_top_bottom(metric_values, names, sort_dir, top_k):
    """Reference ranking convention (hp_depth_pred_writers.py:643-654 / :957-967):
    argsort (reversed for desc), top = tail reversed, bottom = head."""
    values = np.array(metric_values)
    names = np.array(names)
    order = np.argsort(values)
    if sort_dir == "desc":
        order = order[::-1]
    return {"top": names[order[-top_k:]][::-1], "bottom": names[order[:top_k]]}


class WoodscapeHPDepthChamferDistBestWorstPredictionWriter(_WriterBase):
    """Chamfer-distance evaluation: per-sample ranking plus the four cumulative
    variants.  ``device``: where the folds run (the first CUDA device when None;
    raises without one);
    ``chamfer_route``: "pruned" | "brute" | None (the n*m rule) for every pair;
    ``on_pair``: when given, called after each evaluated pair with a dict of its
    sample, metric, value, route, n, m, host-prep and fold seconds, the pruned route's
    statistics and fold lists, its clouds ``p``, ``q`` and its per-point minima
    ``d_pq``, ``d_qp`` (copied to the host only for this caller).
    ``ranked`` holds the top/bottom ``top_k`` names by ``ranking_metric`` after
    ``on_predict_epoch_end``."""

    def __init__(self, rotate_pole=False, prefix="", nside=256, base_pix=8, top_k=2,
                 ranking_metric="chamfer_distance", sort_dir="desc", data_transform=None,
                 mask_background=False, normalize_data=None, interpolation_mode="nearest",
                 run=None, device=None, chamfer_route=None, on_pair=None, **_ignore):
        super().__init__(run=run)
        self.rotate_pole = rotate_pole
        self.nside = nside
        self.base_pix = base_pix
        self.top_k = top_k
        self.data_transform = data_transform
        self.mask_background = mask_background
        self.normalize_data = normalize_data
        self.stats = ndd.get_depth_data_stats(data_transform, mask_background)
        self.interpolation_mode = interpolation_mode
        self.chamfer_route = chamfer_route
        self.on_pair = on_pair
        device = default_device(device)
        self.metrics = {k: dm.ChamferDistance(device=device, route=chamfer_route)
                        for k in METRICS}
        if ranking_metric not in self.metrics:  # eval configs default to seg metrics
            ranking_metric = "chamfer_distance"
        self.metric_name = ranking_metric
        assert sort_dir in ["asc", "desc"]
        self.sort_dir = sort_dir
        self.metric_values = []
        self.names = []
        self.ranked = None
        self.prefix = _norm_prefix(prefix)

    def _foreground(self, x):
        if not self.mask_background:
            return None
        return depth_utils.get_foreground_mask(x, background_val=BACKGROUND)

    def variants(self, hp_pred, hp_mask, cal_info, full_res_mask):
        """The four variants of one sample: (metric name, builder of its (p, q)
        clouds) in the writer's order.  ``hp_pred`` (C, npix) metric depths,
        ``hp_mask`` (npix,) the network-space HP target, ``full_res_mask`` (H, W) the
        metric flat target."""
        hp_mask = np.asarray(
            ndd.unnormalize_and_retransform(
                np.asarray(hp_mask), self.normalize_data, self.stats, self.data_transform
            )
        ).copy()
        hp_mask[np.isinf(hp_mask)] = np.nan
        hp_mask = hp_mask[None]
        hp_pred = np.asarray(hp_pred)[None]
        full_res_mask = np.asarray(full_res_mask, dtype=np.float64)[None]
        hp_fg = self._foreground(hp_mask)
        full_fg = self._foreground(full_res_mask)
        kwargs = dict(nside=self.nside, base_pix=self.base_pix, rotate_pole=self.rotate_pole)

        def hp_cutout(flat):
            return depth_utils.mask_flat_with_hp_cutout(
                flat.copy(), cal_info, base_pix=self.base_pix, nside=self.nside,
                rotate_pole=self.rotate_pole, masking_val=float("nan"))

        def vs_flat(flat, flat_fg):
            return dm.build_chamfer_clouds(hp_pred, flat, cal_info, hp_data=(True, False),
                                           foreground_pix=(hp_fg, flat_fg), **kwargs)

        def native():
            return dm.build_chamfer_clouds(hp_pred, hp_mask, cal_info, hp_data=True,
                                           foreground_pix=hp_fg, **kwargs)

        def full():
            return vs_flat(full_res_mask, full_fg)

        def full_masked():
            masked = hp_cutout(full_res_mask)
            return vs_flat(masked, self._foreground(masked))

        def small_masked():
            masked = hp_cutout(_resize_float(full_res_mask, SMALL_RES,
                                             self.interpolation_mode))
            return vs_flat(masked, self._foreground(masked))

        return list(zip(METRICS, (native, full, full_masked, small_masked)))

    def _prep(self, build):
        t0 = time.perf_counter()
        p, q = build()
        prepared = chamfer_ops.prepare_pair(p, q, self.chamfer_route)
        return p, q, prepared, time.perf_counter() - t0

    def write_on_batch_end(self, preds, batch, batch_idx):
        preds_cf = _cf(preds)
        for hp_pred, hp_mask, name, cal_info, full_res_mask in zip(
            preds_cf, batch["hp_masks"], batch["names"], batch["cal_infos"], batch["masks"]
        ):
            tasks = self.variants(hp_pred, hp_mask, cal_info, full_res_mask)
            # the ranking value reuses the cumulative chamfer_distance update
            # (identical inputs give the identical value)
            value = None
            with ThreadPoolExecutor(max_workers=1) as ex:
                fut = ex.submit(self._prep, tasks[0][1])
                for i, (mkey, _) in enumerate(tasks):
                    p, q, prepped, t_prep = fut.result()
                    if i + 1 < len(tasks):
                        fut = ex.submit(self._prep, tasks[i + 1][1])
                    stats = {} if self.on_pair is not None else None
                    t0 = time.perf_counter()
                    v = self.metrics[mkey].update_clouds(p, q, prepared=prepped, stats=stats)
                    if stats is not None:
                        stats.update(sample=name, metric=mkey, n=len(p), m=len(q), value=v,
                                     t_prep=t_prep, t_fold=time.perf_counter() - t0, p=p, q=q)
                        self.on_pair(stats)
                    if mkey == "chamfer_distance":
                        value = v
            self.metric_values.append(float(value))
            self.names.append(name)

    def on_predict_epoch_end(self):
        """Log the four metrics, rank the samples, and drop the Chamfer side caches:
        no device table stays resident after the evaluation."""
        self.log_metrics(
            {f"{self.prefix}{k}": float(v.compute()) for k, v in self.metrics.items()}
        )
        if self.names:
            self.ranked = _rank_top_bottom(self.metric_values, self.names, self.sort_dir,
                                           self.top_k)
        chamfer_pruned.clear()
