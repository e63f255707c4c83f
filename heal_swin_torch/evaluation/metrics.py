"""Segmentation metrics as accumulating confusion-matrix states (counterpart of the
segmentation part of ``heal_swin_tpu/evaluation/metrics.py``).

torchmetrics 0.3.2 semantics, as the JAX package: IoU per class from the confusion
matrix with absent classes scored 0; micro accuracy, and accuracy over pixels whose
target is not class 0 ("ignored"); 0/0 accuracy is NaN.  States are dicts of f32
tensors on the device of the predictions; every update returns a new state.
"""

from __future__ import annotations

from typing import Dict

import torch


def seg_state_init(num_classes: int, device=None) -> Dict[str, torch.Tensor]:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"confmat": torch.zeros((num_classes, num_classes), dtype=torch.float32,
                                   device=device),
            "correct": z, "total": z.clone(), "correct_ignored": z.clone(),
            "total_ignored": z.clone()}


def seg_state_update(state, preds, target, num_classes: int, sample_mask=None):
    """preds/target: int tensors of one shape; sample_mask: optional bool marking the
    valid elements (or samples, broadcast over the trailing axes)."""
    if sample_mask is None:
        valid = torch.ones(target.shape, dtype=torch.bool, device=target.device)
    else:
        m = sample_mask.reshape(sample_mask.shape + (1,) * (target.ndim - sample_mask.ndim))
        valid = m.expand(target.shape)
    preds = preds.reshape(-1).long()
    target = target.reshape(-1).long()
    valid = valid.reshape(-1)
    vf = valid.float()
    cm = torch.zeros(num_classes * num_classes, dtype=torch.float32, device=target.device)
    cm = cm.index_add(0, target * num_classes + preds, vf).reshape(num_classes, num_classes)
    hit = (preds == target).float()
    ign = vf * (target != 0).float()
    return {"confmat": state["confmat"] + cm,
            "correct": state["correct"] + (vf * hit).sum(),
            "total": state["total"] + vf.sum(),
            "correct_ignored": state["correct_ignored"] + (ign * hit).sum(),
            "total_ignored": state["total_ignored"] + ign.sum()}


def iou_from_confmat(confmat, absent_score: float = 0.0):
    """Per-class IoU with torchmetrics' absent_score semantics."""
    tp = torch.diagonal(confmat)
    denom = confmat.sum(0) + confmat.sum(1) - tp
    return torch.where(denom > 0, tp / torch.clamp_min(denom, 1.0),
                       torch.full_like(tp, absent_score))


def seg_state_merge_confmat(state, cm):
    """Merge a step's (F, F) confusion matrix (target rows, prediction columns), as the
    fused decoder-tail loss emits it; every scalar accumulator follows from it."""
    cm = cm.float()
    correct = torch.trace(cm)
    total = cm.sum()
    return {"confmat": state["confmat"] + cm,
            "correct": state["correct"] + correct,
            "total": state["total"] + total,
            "correct_ignored": state["correct_ignored"] + correct - cm[0, 0],
            "total_ignored": state["total_ignored"] + total - cm[0].sum()}


def seg_state_compute(state, prefix: str, class_names=None) -> Dict[str, float]:
    """Epoch metrics under the reference's names."""
    iou = iou_from_confmat(state["confmat"]).double().cpu()

    def _acc(correct, total):
        total = float(total)
        return float(correct) / total if total > 0 else float("nan")

    out = {f"{prefix}acc": _acc(state["correct"], state["total"]),
           f"{prefix}acc_ignored": _acc(state["correct_ignored"], state["total_ignored"]),
           f"{prefix}iou_global": float(iou.mean()),
           f"{prefix}iou_global_ignored": float(iou[1:].mean()) if len(iou) > 1
           else float(iou.mean())}
    if class_names is not None:
        for c, val in enumerate(iou.tolist()):
            name = class_names[c] if c < len(class_names) else str(c)
            out[f"{prefix}iou_global_class_{c}_{name}"] = float(val)
    return out
