"""The training step and the eval half of the trainer (counterpart of
``heal_swin_tpu/training/trainer.py``): the train step, the eval step with its batch
padding, the validation loop and the predict loop with the prediction writers'
protocol.  They are free functions over a task and an iterable of batches; the Trainer
around them (fit, checkpoints, schedulers, the data modules, the run entry) comes later.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from heal_swin_torch.models.tasks import resolve_model


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


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pad_batch(imgs, targets, dp: int = 1):
    """A ragged batch padded up to a multiple of ``dp``, the data-parallel size (1 on one
    GPU), by repeating its last sample (``Trainer._pad_batch``).  ``targets``: a tensor
    or array of per-sample rows, or a dict, list or tuple of them.  Returns (imgs,
    targets, sample_mask) as tensors on the images' device, the mask (B padded,) bool,
    True for the batch's own samples."""
    imgs = torch.as_tensor(imgs)
    b = imgs.shape[0]
    target_b = -(-b // dp) * dp
    mask = torch.arange(target_b, device=imgs.device) < b

    def pad(a):
        a = torch.as_tensor(a)
        if target_b == b:
            return a
        return torch.cat([a, a[-1:].expand((target_b - b,) + tuple(a.shape[1:]))])

    return pad(imgs), _tree_map(pad, targets), mask


@torch.no_grad()
def eval_step(task, mstate, imgs, targets, sample_mask):
    """One validation batch (the JAX trainer's eval step): the task's loss in eval mode
    with the padded samples masked out, its metric update under the same mask, and
    (metric state, loss * valid, valid), valid the number of the batch's own samples.
    Under ``torch.no_grad()``, so that the forward-only kernels are taken."""
    loss, outputs = task.loss_fn(imgs, targets, deterministic=True, sample_mask=sample_mask)
    mstate = task.metric_update(mstate, outputs, targets, sample_mask=sample_mask)
    valid = torch.as_tensor(sample_mask, device=loss.device).float().sum()
    return mstate, loss * valid, valid


class Validation(NamedTuple):
    """A validation run: the metrics (with ``{prefix}loss``), the samples counted, and
    the samples and seconds after the first batch (the steady state)."""

    metrics: Dict[str, float]
    samples: float
    steady_samples: float
    steady_time: float


def run_validation(task, batches, max_batches: Optional[int] = None, metrics_prefix="val_",
                   with_per_class=True, dp: int = 1) -> Validation:
    """The validation loop over ``batches`` of (imgs, targets) (``Trainer._run_validation``):
    each batch padded (``pad_batch``) and run through ``eval_step``; the metrics of the
    task's state, and ``{prefix}loss`` = sum(loss * valid) / sum(valid).  Each batch's
    loss is fetched to the host, the loop's sync point, so the steady-state time (after
    the first batch) is the device's too."""
    mstate = task.metric_init()
    loss_sum, count = 0.0, 0.0
    t_steady, at_steady = None, 0.0
    for imgs, targets in itertools.islice(batches, max_batches):
        imgs, targets, mask = pad_batch(imgs, targets, dp)
        mstate, batch_loss, valid = eval_step(task, mstate, imgs, targets, mask)
        loss_sum += float(batch_loss)
        count += float(valid)
        if t_steady is None:
            t_steady, at_steady = time.perf_counter(), count
    metrics = task.metric_compute(mstate, metrics_prefix, with_per_class=with_per_class)
    if count:
        metrics[f"{metrics_prefix}loss"] = loss_sum / count
    steady_time = time.perf_counter() - t_steady if t_steady is not None else 0.0
    return Validation(metrics, count, count - at_steady, steady_time)


def validate(task, batches, metrics_prefix="val_") -> Validation:
    """Standalone validation (``Trainer.validate``): ``run_validation`` with the
    per-class metrics."""
    return run_validation(task, batches, metrics_prefix=metrics_prefix, with_per_class=True)


class Prediction(NamedTuple):
    """A predict run: the host predictions of each batch (None with a writer), the
    samples predicted, those after the first batch and their seconds (the steady
    state), the host's seconds blocked on the device's results and in the writer."""

    outputs: Optional[List]
    samples: int
    steady_samples: int
    steady_time: float
    device_time: float
    writer_time: float


def predict(task, batches, params=None, writer=None,
            max_batches: Optional[int] = None) -> Prediction:
    """The predict loop (``Trainer.predict``) over ``batches``, dicts holding the
    images under ``task.input_key``: ``task.predict`` of each, fetched to the host as
    numpy and handed to ``writer.write_on_batch_end(preds, batch, i)``, then
    ``writer.on_predict_epoch_end()``; without a writer the predictions are returned.
    ``params``: the network, a state_dict (loaded once) or None for ``task.model``.
    A writer with ``set_predict_fn`` gets the predict function (the best/worst
    writers re-predict single samples).  One batch in flight: batch i + 1's predict is
    queued on the device before batch i is fetched and written, so the device computes
    while the host writes."""
    model = resolve_model(task.model, params)

    def predict_fn(imgs):
        return task.predict(model, imgs)

    if writer is not None and hasattr(writer, "set_predict_fn"):
        writer.set_predict_fn(lambda imgs: predict_fn(imgs).cpu().numpy())
    outputs = []
    stats = dict(samples=0, device=0.0, writer=0.0)
    t_steady, at_steady = None, 0

    def consume(preds_dev, batch, i):
        nonlocal t_steady, at_steady
        t0 = time.perf_counter()
        preds = preds_dev.cpu().numpy()  # the sync point
        t1 = time.perf_counter()
        stats["device"] += t1 - t0
        stats["samples"] += len(preds)
        if writer is not None:
            writer.write_on_batch_end(preds, batch, i)
            stats["writer"] += time.perf_counter() - t1
        else:
            outputs.append(preds)
        if t_steady is None:
            t_steady, at_steady = time.perf_counter(), stats["samples"]

    pending = None
    for i, batch in enumerate(itertools.islice(batches, max_batches)):
        preds_dev = predict_fn(batch[task.input_key])
        if pending is not None:
            consume(*pending)
        pending = (preds_dev, batch, i)
    if pending is not None:
        consume(*pending)
    steady_time = time.perf_counter() - t_steady if t_steady is not None else 0.0
    if writer is not None:
        writer.on_predict_epoch_end()
    return Prediction(None if writer is not None else outputs, stats["samples"],
                      stats["samples"] - at_steady, steady_time, stats["device"],
                      stats["writer"])
