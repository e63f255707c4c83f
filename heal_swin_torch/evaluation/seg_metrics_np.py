"""Numpy segmentation metrics with torchmetrics-0.3.2 semantics, for the host-side
prediction writers (the port's copy of ``heal_swin_tpu/evaluation/seg_metrics_np.py``;
the reference uses torchmetrics.Accuracy / IoU and their functional forms)."""

from __future__ import annotations

import numpy as np


def nanmean(x) -> float:
    """Mean over non-nan entries (reference utils.nanmean, utils.py:24-26)."""
    x = np.asarray(x, dtype=np.float64)
    return float(np.mean(x[~np.isnan(x)]))


def confusion_matrix(preds, target, num_classes) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (np.asarray(target).reshape(-1), np.asarray(preds).reshape(-1)), 1)
    return cm


def iou_from_confmat(cm, absent_score=0.0) -> np.ndarray:
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    denom = tp + fp + fn
    return np.where(denom > 0, tp / np.maximum(denom, 1), absent_score)


def iou_functional(preds, target, num_classes, absent_score=0.0, reduction="elementwise_mean"):
    """torchmetrics.functional.iou."""
    ious = iou_from_confmat(confusion_matrix(preds, target, num_classes), absent_score)
    if reduction == "none":
        return ious
    return float(np.mean(ious))


def accuracy_functional(preds, target, num_classes=None, ignore_index=None) -> float:
    preds = np.asarray(preds).reshape(-1)
    target = np.asarray(target).reshape(-1)
    if ignore_index is not None:
        keep = target != ignore_index
        preds, target = preds[keep], target[keep]
    if target.size == 0:
        return float("nan")  # torchmetrics 0.3.2: correct/total = 0/0 -> nan
    return float((preds == target).mean())


class Accuracy:
    """torchmetrics.Accuracy accumulator (micro); optional ignore_index."""

    def __init__(self, ignore_index=None):
        self.ignore_index = ignore_index
        self.reset()

    def reset(self):
        self.correct = 0
        self.total = 0

    def update(self, preds, target):
        preds = np.asarray(preds).reshape(-1)
        target = np.asarray(target).reshape(-1)
        if self.ignore_index is not None:
            keep = target != self.ignore_index
            preds, target = preds[keep], target[keep]
        self.correct += int((preds == target).sum())
        self.total += int(target.size)

    def compute(self) -> float:
        if self.total == 0:
            return float("nan")  # torchmetrics 0.3.2: 0/0 -> nan
        return self.correct / self.total


class IoU:
    """torchmetrics.IoU accumulator (confusion-matrix based)."""

    def __init__(self, num_classes, reduction="elementwise_mean", absent_score=0.0):
        self.num_classes = num_classes
        self.reduction = reduction
        self.absent_score = absent_score
        self.reset()

    def reset(self):
        self.confmat = np.zeros((self.num_classes, self.num_classes), dtype=np.int64)

    def update(self, preds, target):
        self.confmat += confusion_matrix(preds, target, self.num_classes)

    def compute(self):
        ious = iou_from_confmat(self.confmat, self.absent_score)
        if self.reduction == "none":
            return ious
        return float(np.mean(ious))
