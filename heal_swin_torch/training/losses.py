"""Loss functions (counterpart of ``heal_swin_tpu/training/losses.py``).

Class-weighted cross entropy with ``torch.nn.CrossEntropyLoss(weight=w)`` semantics:
sum_i w[y_i] nll_i / sum_i w[y_i], the segmentation task's unfused route (the fused
route is ``heal_swin_torch.ops.final_head.final_head_loss``).
"""

from __future__ import annotations

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
