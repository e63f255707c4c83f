"""Optimizer factory (counterpart of ``heal_swin_tpu/training/optimizer.py``).

Adam or AdamW from ``torch.optim``.  torch's Adam applies weight decay as L2 on the
gradient before the moments, the form the JAX package's optax chain reproduces;
AdamW decays decoupled.  Optional clipping by the global gradient norm runs before
every step, as optax's ``clip_by_global_norm``: the gradients are scaled by
max_norm / norm when the norm is at least max_norm.  The host-side learning-rate
schedulers come with the trainer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class OptimizerConfig:
    optimizer_name: str = "Adam"  # "Adam" | "AdamW"
    learning_rate: float = 0.001
    weight_decay: float = 0.0
    scheduler: Optional[str] = None  # None | "reduce_on_plateau" | "exponential"
    scheduler_mode: str = "min"
    scheduler_patience: int = 10
    scheduler_threshold: float = 1e-4
    scheduler_factor: float = 0.5
    scheduler_min_lr: float = 1e-5
    scheduler_monitor: str = "train_loss"


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients of ``params`` by max_norm / norm when their global L2 norm
    is at least max_norm; returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float())
                                                 for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


def make_optimizer(params, config: OptimizerConfig,
                   gradient_clip_val: float = 0.0) -> torch.optim.Optimizer:
    """Adam / AdamW (betas 0.9, 0.999, eps 1e-8) over ``params`` at the config's
    learning rate and weight decay; with ``gradient_clip_val`` > 0 every step first
    clips the gradients by their global norm."""
    params = list(params)
    kw = dict(lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-8,
              weight_decay=config.weight_decay)
    if config.optimizer_name == "Adam":
        opt = torch.optim.Adam(params, **kw)
    elif config.optimizer_name == "AdamW":
        opt = torch.optim.AdamW(params, **kw)
    else:
        raise ValueError(f"unknown optimizer: {config.optimizer_name}")
    if gradient_clip_val and gradient_clip_val > 0:
        def clip(_opt, _args, _kwargs):
            clip_by_global_norm_(params, gradient_clip_val)

        opt.register_step_pre_hook(clip)
    return opt
