"""Minimal prediction writers for the SYNTHETIC datamodules (the port's copy of
``heal_swin_tpu/evaluation/writers.py``), HEALPix and flat.

The full WoodScape writer suite mirrors reference ``heal_swin/evaluation/
*_pred_writers.py`` and lives in ``{flat,hp}_pred_writers.py`` /
``{flat,hp}_depth_pred_writers.py``.  This module only provides the lightweight writers
the synthetic fixtures (``data/synthetic.py``) register: host numpy, each sample's
prediction saved as a compressed npz.  Writers follow the reference's
BasePredictionWriter protocol: ``write_on_batch_end(preds, batch, batch_idx)`` +
``on_predict_epoch_end()``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np



class SegBasePredictionWriter:
    """Minimal base writer: saves per-sample prediction overlays with per-sample IoU in
    the filename (reference flat_pred_writers.py:20-87 / hp_pred_writers.py:20-107)."""

    def __init__(self, dm, output_dir=None, prefix: str = "", num_classes: int = 2,
                 target_key: str = "hp_masks", pred_key: str = "hp_imgs", run=None, **kw):
        self.dm = dm
        self.output_dir = Path(output_dir) / "predictions" if output_dir else None
        if self.output_dir:
            self.output_dir.mkdir(parents=True, exist_ok=True)
        self.prefix = prefix
        self.num_classes = num_classes
        self.target_key = target_key
        self.run = run
        self._acc_correct = 0
        self._acc_total = 0

    def _sample_iou(self, pred, target):
        cm = np.zeros((self.num_classes, self.num_classes))
        np.add.at(cm, (target.reshape(-1), pred.reshape(-1)), 1)
        tp = np.diag(cm)
        denom = cm.sum(0) + cm.sum(1) - tp
        iou = np.where(denom > 0, tp / np.maximum(denom, 1), 0.0)
        return float(iou.mean())

    def write_on_batch_end(self, preds, batch, batch_idx):
        targets = np.asarray(batch[self.target_key])
        names = batch.get("names", [f"b{batch_idx}_{i}" for i in range(len(preds))])
        for i, (p, t) in enumerate(zip(preds, targets)):
            self._acc_correct += int((p == t).sum())
            self._acc_total += int(t.size)
            if self.output_dir is not None:
                iou = self._sample_iou(p.astype(int), t.astype(int))
                np.savez_compressed(
                    self.output_dir / f"{self.prefix}{names[i]}_iou={iou:.4f}.npz",
                    pred=p.astype(np.uint8),
                )

    def on_predict_epoch_end(self):
        if self.run is not None and self._acc_total:
            self.run.log_metric(f"{self.prefix}pred_acc", self._acc_correct / self._acc_total)


class DepthBasePredictionWriter(SegBasePredictionWriter):
    """Depth variant of the minimal base writer: per-sample MSE in filename; targets
    are network-space depth maps, predictions metric depths (channel 0)."""

    def __init__(self, dm, data_config=None, **kw):
        super().__init__(dm, **kw)
        from heal_swin_torch.data import normalize_depth_data as ndd

        dc = data_config.common_depth if data_config is not None else None
        self.dc = dc
        self.stats = (
            ndd.get_depth_data_stats(dc.data_transform, dc.mask_background)
            if dc is not None
            else None
        )
        self._sq = 0.0
        self._n = 0.0

    def _to_metric(self, t):
        from heal_swin_torch.data import normalize_depth_data as ndd

        if self.dc is None:
            return t
        return np.asarray(
            ndd.unnormalize_and_retransform(
                t, self.dc.normalize_data, self.stats, self.dc.data_transform
            )
        )

    def write_on_batch_end(self, preds, batch, batch_idx):
        targets = self._to_metric(np.asarray(batch[self.target_key], dtype=np.float64))
        names = batch.get("names", [f"b{batch_idx}_{i}" for i in range(len(preds))])
        preds = np.asarray(preds)
        for i, (p, t) in enumerate(zip(preds, targets)):
            pm = p[..., 0] if p.ndim > t.ndim else p
            valid = np.isfinite(pm) & np.isfinite(t)
            mse = float(np.mean((pm[valid] - t[valid]) ** 2)) if valid.any() else float("nan")
            self._sq += mse if np.isfinite(mse) else 0.0
            self._n += 1
            if self.output_dir is not None:
                np.savez_compressed(
                    self.output_dir / f"{self.prefix}{names[i]}_mse={mse:.2f}.npz",
                    pred=pm.astype(np.float32),
                )

    def on_predict_epoch_end(self):
        if self.run is not None and self._n:
            self.run.log_metric(f"{self.prefix}pred_mse", self._sq / self._n)


def get_synthetic_writer(writer_name: Optional[str], dm, **kwargs):
    """Writer registry for the synthetic datamodules (mirrors the reference's
    per-datamodule get_pred_writer registries, hp_datasets.py:390-396)."""
    target_key = "hp_masks" if hasattr(dm, "nside") else "s2_masks"
    if writer_name not in (None, "base_writer"):
        raise ValueError(f"unknown writer for synthetic data: {writer_name}")
    if dm.get_classes() == 1:  # depth
        return DepthBasePredictionWriter(
            dm, data_config=getattr(dm, "config", None), target_key=target_key, **kwargs
        )
    return SegBasePredictionWriter(
        dm, num_classes=dm.get_classes(), target_key=target_key, **kwargs
    )
