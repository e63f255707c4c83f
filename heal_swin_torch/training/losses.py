"""Loss functions (counterpart of ``heal_swin_tpu/training/losses.py``).

- Class-weighted cross entropy with ``torch.nn.CrossEntropyLoss(weight=w)``
  semantics: sum_i w[y_i] nll_i / sum_i w[y_i], the segmentation task's unfused route
  (the fused route is ``heal_swin_torch.ops.final_head.final_head_loss``).
- The depth regression losses on inf-masked targets, the depth task's unfused route
  (the fused route is ``final_head_depth_loss``): a position whose target is inf adds
  nothing and leaves the mean, which divides by max(count, 1).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch


def weighted_cross_entropy(logits, targets, class_weights=None, sample_mask=None):
    """logits: (..., F) float; targets: (...) int.  A target outside [0, F) has a zero
    one-hot row (no nll and no weight), as ``jax.nn.one_hot`` gives.  ``sample_mask``:
    optional (B,) or element-shaped bool excluding padded samples from the mean."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    n_classes = logits.shape[-1]
    onehot = (targets.long()[..., None]
              == torch.arange(n_classes, device=logits.device)).to(logp.dtype)
    nll = -(logp * onehot).sum(-1)
    if class_weights is None:
        w = torch.ones_like(nll)
    else:
        cw = torch.as_tensor(class_weights, dtype=torch.float32, device=logits.device)
        w = (onehot * cw).sum(-1)
    if sample_mask is not None:
        m = sample_mask.reshape(sample_mask.shape + (1,) * (nll.ndim - sample_mask.ndim))
        w = w * m.to(w.dtype)
    return (w * nll).sum() / torch.clamp_min(w.sum(), 1e-12)


def _masked_mean(values, mask):
    return torch.where(mask, values, 0.0).sum() / torch.clamp_min(mask.sum(), 1)


def _masked_diff(means, target, mask):
    """means - target with the mask applied inside the subtraction: a masked position
    gives an exact 0 to the value and to the backward, so an inf target (or a
    non-finite prediction there) never reaches the arithmetic."""
    return torch.where(mask, means - torch.where(mask, target, 0.0), 0.0)


def _abs(x):
    """|x| with jnp.abs's gradient: 1 at x = 0 (torch.abs gives 0 there)."""
    return torch.where(x >= 0, x, -x)


def mse(preds, target):
    """Depth "l2": the mean of half the squared difference over non-inf targets.
    preds: (B, N, f_out), channel 0 the mean prediction; target: (B, N)."""
    mask = ~torch.isinf(target)
    return _masked_mean(torch.square(_masked_diff(preds[..., 0], target, mask)) / 2.0, mask)


def mean_log_var_loss(preds, target):
    """Gaussian NLL over the (mean, logvar) channels."""
    mask = ~torch.isinf(target)
    lv = torch.where(mask, preds[..., 1], 0.0)
    vals = 0.5 * lv + torch.square(_masked_diff(preds[..., 0], target, mask)) * (
        0.5 * torch.exp(-lv))
    return _masked_mean(vals, mask)


def l1_loss(preds, target):
    mask = ~torch.isinf(target)
    return _masked_mean(_abs(_masked_diff(preds[..., 0], target, mask)), mask)


def huber_loss(preds, target, delta: float = 1.0):
    """torch SmoothL1Loss(beta=delta): 0.5 d^2 / delta if |d| < delta else |d| - delta/2."""
    mask = ~torch.isinf(target)
    d = _abs(_masked_diff(preds[..., 0], target, mask))
    return _masked_mean(torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta), mask)


def get_depth_loss(common_depth_config) -> Callable:
    """The depth loss of a ``CommonDepthConfig``: the NLL from the start when
    ``use_logvar`` is set, else l2 / l1 / huber by name."""
    if common_depth_config.use_logvar:
        return mean_log_var_loss
    losses = {"l2": mse, "l1": l1_loss,
              "huber": partial(huber_loss, delta=common_depth_config.huber_delta)}
    return losses[common_depth_config.loss]
