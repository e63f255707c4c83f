"""The training step (counterpart of the jitted step in
``heal_swin_tpu/training/trainer.py``); the Trainer around it (fit, validation,
checkpoints) comes later.
"""

from __future__ import annotations

import torch


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of training step ``step``, the only source of its masks
    (DropPath, element and attention dropout, drawn in the order the modules run): on
    ``device``, seeded from the run's seed and the step index (the JAX trainer folds the
    step index into its host key), so a step is reproducible from the seed alone."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(step)) % (2 ** 63))


def train_step(task, optimizer: torch.optim.Optimizer, mstate, imgs, targets,
               generator: torch.Generator):
    """One optimizer step of ``task`` on a batch: forward in training mode (dropout
    masks from ``generator``), loss, backward, ``optimizer.step()``, and the metric
    update.  Returns (the loss, detached, and the updated metric state)."""
    task.model.train()
    optimizer.zero_grad(set_to_none=True)
    loss, outputs = task.loss_fn(imgs, targets, generator=generator, deterministic=False)
    loss.backward()
    optimizer.step()
    mstate = task.metric_update(mstate, outputs.detach(), targets)
    return loss.detach(), mstate
