"""Metrics as accumulating states (counterpart of
``heal_swin_tpu/evaluation/metrics.py``).  States are dicts of f32 tensors on the
device of the predictions; every update returns a new state.

- Segmentation: torchmetrics 0.3.2 semantics, as the JAX package: IoU per class from
  the confusion matrix with absent classes scored 0; micro accuracy, and accuracy
  over pixels whose target is not class 0 ("ignored"); 0/0 accuracy is NaN.
- Depth: streaming sums over the pairs whose prediction and target are finite: mse,
  mae, RelSE / RelAE against the dataset-mean predictor, SILogE, the mean predicted
  std of a logvar channel, and iRMSE, which inverts the raw values first (an inf
  target counts as 0, a zero depth drops out).

The state inits put the state on ``device``: the first CUDA device when None (they
raise without one), the CPU only when asked for.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from heal_swin_torch.ops._dispatch import default_device


def seg_state_init(num_classes: int, device=None) -> Dict[str, torch.Tensor]:
    device = default_device(device)
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


_DEPTH_KEYS = ("sq_err", "abs_err", "count", "sq_rel_ref", "abs_rel_ref", "inv_sq_err",
               "inv_count", "silog_d", "silog_d2", "silog_count", "std_sum", "std_count")


def depth_state_init(device=None) -> Dict[str, torch.Tensor]:
    device = default_device(device)
    return {k: torch.zeros((), dtype=torch.float32, device=device) for k in _DEPTH_KEYS}


def depth_state_update(state, pred, target, dataset_mean: Optional[float] = None,
                       log_var=None):
    """pred/target: float tensors of one shape (the mean-depth channel); log_var:
    optional logvar channel of the same shape."""
    pred = pred.reshape(-1).float()
    target = target.reshape(-1).float()
    valid = torch.isfinite(target) & torch.isfinite(pred)
    t = torch.where(valid, target, 1.0)
    p = torch.where(valid, pred, 1.0)
    d = p - t

    def vsum(v, mask=valid):
        return torch.where(mask, v, 0.0).sum()

    out = dict(state)
    out["sq_err"] = state["sq_err"] + vsum(d * d)
    out["abs_err"] = state["abs_err"] + vsum(torch.abs(d))
    out["count"] = state["count"] + valid.float().sum()
    if dataset_mean is not None:
        dm = dataset_mean - t
        out["sq_rel_ref"] = state["sq_rel_ref"] + vsum(dm * dm)
        out["abs_rel_ref"] = state["abs_rel_ref"] + vsum(torch.abs(dm))
    # iRMSE: invert to 1/km on the raw values, then keep the pairs whose inverses are
    # finite (inf depths invert to 0 and count, zero depths invert to inf and drop out)
    inv_p = 1.0 / (0.001 * pred)
    inv_t = 1.0 / (0.001 * target)
    inv_valid = torch.isfinite(inv_p) & torch.isfinite(inv_t)
    inv_d = torch.where(inv_valid, inv_p, 0.0) - torch.where(inv_valid, inv_t, 0.0)
    out["inv_sq_err"] = state["inv_sq_err"] + vsum(inv_d * inv_d, inv_valid)
    out["inv_count"] = state["inv_count"] + inv_valid.float().sum()
    # SILog over positive pairs: mean(d^2) - mean(d)^2 at compute time
    log_valid = valid & (p > 0) & (t > 0)
    ld = (torch.log(torch.where(log_valid, t, 1.0))
          - torch.log(torch.where(log_valid, p, 1.0)))
    out["silog_d"] = state["silog_d"] + vsum(ld, log_valid)
    out["silog_d2"] = state["silog_d2"] + vsum(ld * ld, log_valid)
    out["silog_count"] = state["silog_count"] + log_valid.float().sum()
    if log_var is not None:
        lv = log_var.reshape(-1).float()
        lv_valid = valid & torch.isfinite(lv)
        out["std_sum"] = state["std_sum"] + vsum(torch.exp(0.5 * lv), lv_valid)
        out["std_count"] = state["std_count"] + lv_valid.float().sum()
    return out


def depth_state_compute(state, prefix: str) -> Dict[str, float]:
    """Epoch metrics under the reference's names; RelSE/RelAE only with a dataset
    mean, mean_std only with a logvar channel."""
    s = {k: float(v) for k, v in state.items()}
    n = max(s["count"], 1.0)
    n_inv = max(s["inv_count"], 1.0)
    n_log = max(s["silog_count"], 1.0)
    out = {f"{prefix}mse": s["sq_err"] / n,
           f"{prefix}mae": s["abs_err"] / n,
           f"{prefix}iRMSE": math.sqrt(s["inv_sq_err"] / n_inv),
           f"{prefix}SILogE": s["silog_d2"] / n_log - (s["silog_d"] / n_log) ** 2}
    if s["sq_rel_ref"] > 0:
        out[f"{prefix}RelSE"] = s["sq_err"] / s["sq_rel_ref"]
        out[f"{prefix}RelAE"] = s["abs_err"] / s["abs_rel_ref"]
    if s["std_count"] > 0:
        out[f"{prefix}mean_std"] = s["std_sum"] / s["std_count"]
    return out
