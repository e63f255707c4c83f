"""Optimizer factory and host-side learning-rate schedulers (counterpart of
``heal_swin_tpu/training/optimizer.py``).

Adam or AdamW from ``torch.optim``.  torch's Adam applies weight decay as L2 on the
gradient before the moments, the form the JAX package's optax chain reproduces;
AdamW decays decoupled.  Optional clipping by the global gradient norm runs before
every step, as optax's ``clip_by_global_norm``: the gradients are scaled by
max_norm / norm when the norm is at least max_norm.

The schedulers (ReduceLROnPlateau, ExponentialLR) run on the host between epochs and
set the learning rate of the optimizer's param groups (``set_learning_rate``), as the
JAX trainer sets its injected optax hyperparameter.  ``MultiSteps`` accumulates
gradients over k micro-batches as ``optax.MultiSteps`` does.
"""

from __future__ import annotations

import math
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


def set_learning_rate(optimizer, lr: float):
    """Set the learning rate of every param group of ``optimizer``."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer


def get_learning_rate(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


class MultiSteps:
    """Gradient accumulation as ``optax.MultiSteps`` (``use_grad_mean``): each
    ``step()`` folds the parameters' gradients into a running mean (Welford: acc += (g
    - acc) / (n + 1)); every ``every_k``-th call hands the mean to the inner
    optimizer, whose step (clipping included) and step count move once every k.  The
    parameters do not move in between."""

    def __init__(self, optimizer: torch.optim.Optimizer, every_k: int):
        self.inner = optimizer
        self.every_k = int(every_k)
        self.mini_step = 0
        self.acc = None

    @property
    def param_groups(self):
        return self.inner.param_groups

    def _params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    def zero_grad(self, set_to_none: bool = True):
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self):
        params = self._params()
        if self.acc is None:
            self.acc = [torch.zeros_like(p) for p in params]
        n = self.mini_step
        for p, a in zip(params, self.acc):
            g = p.grad if p.grad is not None else torch.zeros_like(a)
            a.add_((g - a) / (n + 1))
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return
        for p, a in zip(params, self.acc):
            p.grad = a.clone()
        self.inner.step()
        for a in self.acc:
            a.zero_()
        self.mini_step = 0

    def state_dict(self):
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "acc": None if self.acc is None else [a.clone() for a in self.acc]}

    def load_state_dict(self, d):
        self.inner.load_state_dict(d["inner"])
        self.mini_step = int(d["mini_step"])
        if d["acc"] is None:
            self.acc = None
        else:
            self.acc = [torch.as_tensor(a).to(p.device, p.dtype)
                        for a, p in zip(d["acc"], self._params())]


class ReduceLROnPlateau:
    """Host-side mirror of torch.optim.lr_scheduler.ReduceLROnPlateau (rel threshold),
    as the JAX package's: ``step(metrics)`` reads the config's monitor."""

    def __init__(self, config: OptimizerConfig):
        self.cfg = config
        self.lr = config.learning_rate
        self.best = math.inf if config.scheduler_mode == "min" else -math.inf
        self.num_bad_epochs = 0

    def _is_better(self, current):
        t = self.cfg.scheduler_threshold
        if self.cfg.scheduler_mode == "min":
            return current < self.best * (1.0 - t)
        return current > self.best * (1.0 + t)

    def step(self, metrics: dict) -> float:
        current = metrics.get(self.cfg.scheduler_monitor)
        if current is None:
            return self.lr
        if self._is_better(current):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.cfg.scheduler_patience:
            self.lr = max(self.lr * self.cfg.scheduler_factor, self.cfg.scheduler_min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self):
        return {"lr": self.lr, "best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, d):
        self.lr, self.best, self.num_bad_epochs = d["lr"], d["best"], d["num_bad_epochs"]


class ExponentialLR:
    """lr <- lr * factor each epoch (the reference's LightningExponentialLR takes
    scheduler_factor as gamma)."""

    def __init__(self, config: OptimizerConfig):
        self.cfg = config
        self.lr = config.learning_rate

    def step(self, metrics: dict) -> float:
        self.lr = self.lr * self.cfg.scheduler_factor
        return self.lr

    def state_dict(self):
        return {"lr": self.lr}

    def load_state_dict(self, d):
        self.lr = d["lr"]


def make_scheduler(config: OptimizerConfig):
    if config.scheduler is None or config.scheduler == "None":
        return None
    if config.scheduler == "reduce_on_plateau":
        return ReduceLROnPlateau(config)
    if config.scheduler == "exponential":
        return ExponentialLR(config)
    raise ValueError(f"unknown scheduler: {config.scheduler}")
