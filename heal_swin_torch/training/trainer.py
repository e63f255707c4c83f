"""The trainer (counterpart of ``heal_swin_tpu/training/trainer.py``).

The steps are free functions over a task and an iterable of batches: the train step,
the eval step with its batch padding, the validation loop and the predict loop with
the prediction writers' protocol.  ``Trainer`` runs them on one GPU: ``fit`` (seeded
init, resume, sanity validation, batch limits, mid-epoch validation, gradient
accumulation and clipping, ``terminate_on_nan``, host-side LR schedulers, top-k
checkpoints saved asynchronously, early stopping, tracked metrics under the JAX
trainer's names), ``validate`` and ``predict``.

- Each train step's dropout masks come from ``step_generator(seed, global_step)``,
  so a resumed run draws the masks the uninterrupted run draws.
- The host batches reach the device through pinned buffers copied ``non_blocking`` on
  a side stream by a background thread, ``depth`` batches ahead
  (``_device_prefetch``).
- The loss is fetched to the host only every ``log_every_n_steps`` steps (or every step
  with ``terminate_on_nan``) and at the epoch's end; the epoch loss accumulates on the
  device.
- A checkpoint holds the scheduler's state after the epoch's step, so a resumed run
  takes the learning rate the uninterrupted one takes (the JAX trainer saves it before
  the step, so its resume repeats the last epoch's rate).
"""

from __future__ import annotations

import itertools
import math
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from heal_swin_torch.models.tasks import resolve_model
from heal_swin_torch.ops._dispatch import default_device
from heal_swin_torch.training import checkpoint as ckpt_lib
from heal_swin_torch.training.checkpoint import _tree_map
from heal_swin_torch.training.optimizer import (MultiSteps, get_learning_rate,
                                                make_optimizer, make_scheduler,
                                                set_learning_rate)
from heal_swin_torch.training.train_config import PLConfig, TrainConfig, warn_ignored_fields


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


def _limit(n_batches: int, limit) -> int:
    if isinstance(limit, bool):
        return n_batches
    if isinstance(limit, float):
        return max(1, int(n_batches * limit)) if limit < 1.0 else n_batches
    return min(n_batches, int(limit))


@dataclass
class FitResult:
    epochs_run: int
    global_step: int
    best_ckpt_path: Optional[str]
    last_metrics: Dict[str, float]


class Trainer:
    """The fit / validate / predict loops on one device (``device``: the first CUDA
    device when None, raising without one; the CPU only when asked for).  The task's
    network must live on that device.  ``run``: a tracking run (``tracking``'s stores)
    or None; ``ckpt_dir``: where ``fit`` keeps its checkpoints, or None."""

    def __init__(self, pl_config: PLConfig, train_config: Optional[TrainConfig] = None,
                 run=None, ckpt_dir=None, device=None):
        self.pl = pl_config
        self.tc = train_config or TrainConfig()
        self.run = run
        warn_ignored_fields(pl_config)
        n_devices = pl_config.num_devices()
        if (n_devices or 1) > 1 or int(pl_config.num_nodes or 1) > 1:
            raise NotImplementedError(
                f"gpus={pl_config.gpus!r}, num_nodes={pl_config.num_nodes}: the trainer "
                "runs on one GPU; multi-GPU data parallelism is still to be ported "
                "(ROADMAP queue 1 item 6)")
        if pl_config.seq_parallel_devices > 1:
            raise NotImplementedError(
                f"seq_parallel_devices={pl_config.seq_parallel_devices}: sequence "
                "parallelism is still to be ported (ROADMAP queue 1 item 6)")
        self.device = default_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.ckpt_manager = None
        if ckpt_dir is not None and pl_config.checkpoint_callback and not pl_config.fast_dev_run:
            self.ckpt_manager = ckpt_lib.CheckpointManager(
                ckpt_dir, monitor=self.tc.ckpt_metric, mode=self.tc.ckpt_mode, save_top_k=3)
        self.global_step = 0
        self.current_epoch = 0
        self.optimizer = None

    # ------------------------------------------------------------------ util
    def _log(self, metrics: Dict[str, float], step: Optional[int] = None):
        if self.run is not None:
            s = (step if step is not None else self.global_step) + self.tc.logging_step_offset
            self.run.log_metrics(metrics, step=s)

    def _device_memory_stats(self):
        """The device's memory in MB under the JAX trainer's names (the reference's
        MLFlowGPUStatsMonitor, logging_callbacks.py:218-232): allocated now, the peak,
        and the card's total.  Empty on the CPU."""
        if self.device.type != "cuda":
            return {}
        stats = torch.cuda.memory_stats(self.device)
        total = torch.cuda.get_device_properties(self.device).total_memory
        return {"device0 memory.used in MB": stats["allocated_bytes.all.current"] / 2 ** 20,
                "device0 memory.peak in MB": stats["allocated_bytes.all.peak"] / 2 ** 20,
                "device0 memory.limit in MB": total / 2 ** 20}

    def _check_device(self, task):
        dev = next(task.model.parameters()).device
        if dev != self.device:
            raise ValueError(f"the task's network is on {dev}, the trainer on {self.device}: "
                             "build the task on the trainer's device")

    def _device_prefetch(self, batches, depth=2):
        """Host -> device staging of ``batches``, (host batch, extras...) tuples whose
        batch is a numpy array or a dict / list / tuple of them: a background thread
        copies each batch into pinned host buffers and to the device ``non_blocking`` on
        a side stream, up to ``depth`` batches ahead of the consumer, whose stream waits
        on the copy's event before using it.  Yields (device batch, extras...); an error
        of ``batches`` is raised here.  On the CPU the arrays become tensors in place."""
        dev = self.device
        if dev.type != "cuda":
            for batch, *extras in batches:
                yield (_tree_map(torch.as_tensor, batch), *extras)
            return
        copy_stream = torch.cuda.Stream(dev)
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        end = object()
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                with torch.cuda.device(dev), torch.cuda.stream(copy_stream):
                    for batch, *extras in batches:
                        host = _tree_map(lambda a: torch.as_tensor(a).pin_memory(), batch)
                        on_dev = _tree_map(lambda t: t.to(dev, non_blocking=True), host)
                        done = torch.cuda.Event()
                        done.record(copy_stream)
                        if stop.is_set() or not put((on_dev, done, extras)):
                            return
            except BaseException as e:  # raised on the consumer's side
                put((end, e))
                return
            put((end, None))

        t = threading.Thread(target=worker, daemon=True, name="device-prefetch")
        t.start()
        try:
            while True:
                on_dev, done, *rest = q.get()
                if on_dev is end:
                    if done is not None:
                        raise done
                    return
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(done)
                _tree_map(lambda x: x.record_stream(stream), on_dev)
                yield (on_dev, *rest[0])
        finally:
            stop.set()  # an early exit (batch limit, max_steps) stops the staging

    def _meta(self, scheduler):
        return {"run_id": self.run.run_id if self.run else None,
                "experiment": self.tc.mlflow_expmt, "global_step": self.global_step,
                "scheduler": scheduler.state_dict() if scheduler else None}

    # ------------------------------------------------------------------- fit
    def fit(self, task, datamodule, resume_state: Optional[dict] = None) -> FitResult:
        """Train ``task`` on ``datamodule``'s train loader, validating on its val
        loader (``heal_swin_tpu/training/trainer.py`` ``Trainer.fit``).  The network's
        weights are drawn from ``TrainConfig.seed`` (0 when None) through
        ``reset_parameters``, then replaced by ``TrainConfig.load_checkpoint`` (weights
        only), ``PLConfig.resume_from_checkpoint`` (weights, optimizer, scheduler,
        epoch and global step) or ``resume_state["params"]`` (a state_dict).  The
        optimizer is ``self.optimizer`` afterwards."""
        pl, tc = self.pl, self.tc
        self._check_device(task)
        model = task.model
        dev = self.device
        seed = tc.seed if tc.seed is not None else 0

        train_loader = datamodule.train_dataloader()
        train_loader.drop_last = True
        # tiny subsets (manual-overfit) must still fill one batch
        avail = (train_loader.indices if train_loader.indices is not None
                 else np.arange(len(train_loader.dataset)))
        if len(avail) < train_loader.batch_size:
            train_loader.indices = np.resize(avail, train_loader.batch_size)

        # weights, optimizer, scheduler
        model.reset_parameters(torch.Generator().manual_seed(seed))
        accum = pl.accumulate_grad_batches if isinstance(pl.accumulate_grad_batches, int) else 1
        opt = make_optimizer(model.parameters(), task.optimizer_config,
                             gradient_clip_val=pl.gradient_clip_val)
        if accum > 1:
            opt = MultiSteps(opt, accum)
        self.optimizer = opt
        scheduler = make_scheduler(task.optimizer_config)

        start_epoch = 0
        if tc.load_checkpoint:  # warm start, weights only (reference train.py:193-200)
            state, _, _ = ckpt_lib.load_checkpoint(tc.load_checkpoint)
            model.load_state_dict(state)
        if pl.resume_from_checkpoint:  # full resume (reference resume.py)
            state, opt_state, meta = ckpt_lib.load_checkpoint(pl.resume_from_checkpoint)
            model.load_state_dict(state)
            opt.load_state_dict(opt_state)
            start_epoch = int(meta.get("epoch", -1)) + 1
            self.global_step = int(meta.get("global_step", 0))
            if scheduler is not None and meta.get("scheduler"):
                scheduler.load_state_dict(meta["scheduler"])
                set_learning_rate(opt, scheduler.lr)
        if resume_state and resume_state.get("params") is not None:
            model.load_state_dict(resume_state["params"])

        max_epochs = pl.max_epochs if pl.max_epochs is not None else 1000
        if pl.fast_dev_run:
            max_epochs = 1

        # sanity validation (Lightning num_sanity_val_steps)
        if pl.num_sanity_val_steps and not pl.fast_dev_run:
            self._run_validation(task, datamodule, max_batches=pl.num_sanity_val_steps,
                                 log=False)

        best_metrics: Dict[str, float] = {}
        es_best = -math.inf if tc.early_stopping_mode == "max" else math.inf
        es_bad_epochs = 0
        stop = False
        saved_any_ckpt = False

        epoch = start_epoch
        last_metrics: Dict[str, float] = {}
        for epoch in range(start_epoch, max_epochs):
            self.current_epoch = epoch
            if hasattr(task, "set_epoch"):
                task.set_epoch(epoch)  # the loss it switches to is read by the next step
            train_loader.set_epoch(epoch)
            n_train_batches = _limit(len(train_loader), pl.limit_train_batches)
            if pl.fast_dev_run:
                n_train_batches = 1

            # val_check_interval (Lightning semantics): float < 1.0 -> validate every
            # that fraction of the epoch (plus the epoch-end check); int -> every N
            # train batches.  Only on epochs due per check_val_every_n_epoch.
            val_epoch_due = (epoch + 1) % pl.check_val_every_n_epoch == 0 or pl.fast_dev_run
            vci = pl.val_check_interval
            if isinstance(vci, float):
                vci_batches = None if vci >= 1.0 else max(1, int(n_train_batches * vci))
            else:
                vci_batches = max(1, int(vci))

            mstate = task.metric_init()
            loss_acc = torch.zeros((), device=dev)
            loss = None
            n_steps_epoch = 0
            t0 = time.time()
            samples_seen = 0
            mid_val_time = 0.0  # mid-epoch validation is not train time
            val_metrics: Dict[str, float] = {}
            steady = None

            def staged_train_batches():
                for imgs, targets in itertools.islice(iter(train_loader), n_train_batches):
                    yield (imgs, targets), imgs.shape[0]

            for (imgs, targets), bsz in self._device_prefetch(staged_train_batches()):
                loss, mstate = train_step(task, opt, mstate, imgs, targets,
                                          step_generator(seed, self.global_step, dev))
                loss_acc += loss
                self.global_step += 1
                n_steps_epoch += 1
                samples_seen += bsz
                if steady is None:
                    steady = (_Mark(dev), samples_seen)

                if pl.terminate_on_nan or self.global_step % pl.log_every_n_steps == 0:
                    loss_val = float(loss)
                    if pl.terminate_on_nan and not math.isfinite(loss_val):
                        raise FloatingPointError(
                            f"non-finite train loss {loss_val} at step {self.global_step}")
                    if self.global_step % pl.log_every_n_steps == 0:
                        self._log({"train_loss_step": loss_val})
                if pl.max_steps is not None and self.global_step >= pl.max_steps:
                    stop = True
                    break

                if (val_epoch_due and vci_batches is not None
                        and n_steps_epoch % vci_batches == 0
                        and n_steps_epoch < n_train_batches):
                    # mid-epoch validation; the epoch-end check below still runs, so
                    # float intervals match Lightning's "each fraction including 100%"
                    float(loss)  # drain the queued steps before timing validation
                    tv = time.time()
                    val_metrics = self._run_validation(task, datamodule)
                    last_metrics.update(val_metrics)
                    mid_val_time += time.time() - tv

            if n_steps_epoch:
                end = _Mark(dev)
                float(loss)  # the epoch's steps done before the clock stops
                self.last_train_steady_time = steady[0].seconds_to(end)
                self.last_train_steady_samples = samples_seen - steady[1]
            epoch_time = time.time() - t0 - mid_val_time
            train_metrics = task.metric_compute(mstate, "train_")
            if n_steps_epoch:
                train_metrics["train_loss"] = float(loss_acc) / n_steps_epoch
            train_metrics["epoch"] = epoch
            train_metrics["train_time_per_sample in ms"] = (
                epoch_time * 1000.0 / max(samples_seen, 1))
            train_metrics[f"lr-{task.optimizer_config.optimizer_name}"] = get_learning_rate(opt)
            if tc.log_gpu_stats:
                train_metrics.update(self._device_memory_stats())
            self._log(train_metrics)
            last_metrics.update(train_metrics)

            # epoch-end validation (supersedes a mid-epoch one)
            if val_epoch_due:
                n_val = 1 if pl.fast_dev_run else None
                val_metrics = self._run_validation(task, datamodule, max_batches=n_val)
                last_metrics.update(val_metrics)

            all_metrics = {**train_metrics, **val_metrics}

            # the scheduler's step, then the checkpoint (with the stepped scheduler, so
            # that a resume continues at the new rate), then the new rate
            new_lr = scheduler.step(all_metrics) if scheduler is not None else None
            if self.ckpt_manager is not None:
                self.ckpt_manager.save_epoch(epoch, all_metrics, model.state_dict(),
                                             opt.state_dict(), self._meta(scheduler))
                saved_any_ckpt = True
            if new_lr is not None:
                set_learning_rate(opt, new_lr)

            # early stopping (reference train.py:106-114)
            if tc.early_stopping and tc.early_stopping_monitor in all_metrics:
                cur = all_metrics[tc.early_stopping_monitor]
                better = (cur > es_best + tc.early_stopping_min_delta
                          if tc.early_stopping_mode == "max"
                          else cur < es_best - tc.early_stopping_min_delta)
                if better:
                    es_best = cur
                    es_bad_epochs = 0
                else:
                    es_bad_epochs += 1
                    if es_bad_epochs >= tc.early_stopping_patience and (
                            pl.min_epochs is None or epoch + 1 >= pl.min_epochs):
                        stop = True

            best_metrics = all_metrics
            if stop:
                break

        if self.ckpt_manager is not None and not saved_any_ckpt and start_epoch > 0:
            # zero epochs ran on a resumed run (the resume of a finished run): save the
            # restored state as last.ckpt so that the new run is self-contained.  A
            # fresh run with max_epochs=0 saves nothing: epoch=0 recorded for untrained
            # weights would make a later resume skip epoch 0.
            self.ckpt_manager.save_epoch(start_epoch - 1, last_metrics, model.state_dict(),
                                         opt.state_dict(), self._meta(scheduler))

        best_path = None
        if self.ckpt_manager is not None:
            p = self.ckpt_manager.finalize_best()
            best_path = str(p) if p else None

        return FitResult(epochs_run=epoch - start_epoch + 1, global_step=self.global_step,
                         best_ckpt_path=best_path, last_metrics=best_metrics)

    # ------------------------------------------------------------- validation
    def _run_validation(self, task, datamodule, max_batches=None, log=True,
                        metrics_prefix="val_", with_per_class=True):
        loader = datamodule.val_dataloader()
        n = _limit(len(loader), self.pl.limit_val_batches)
        if max_batches is not None:
            n = min(n, max_batches)
        staged = ((imgs, targets) for ((imgs, targets),) in self._device_prefetch(
            (b,) for b in itertools.islice(iter(loader), n)))
        v = run_validation(task, staged, metrics_prefix=metrics_prefix,
                           with_per_class=with_per_class)
        self.last_eval_samples = v.samples
        self.last_eval_steady_samples = v.steady_samples
        self.last_eval_steady_time = v.steady_time
        if log:
            self._log(v.metrics)
        return v.metrics

    def validate(self, task, datamodule, params=None, metrics_prefix="val_"):
        """Standalone validation (the reference's trainer.validate in evaluate.py):
        ``params`` a state_dict to load into the task's network first, or None."""
        self._check_device(task)
        resolve_model(task.model, params)
        return self._run_validation(task, datamodule, metrics_prefix=metrics_prefix,
                                    with_per_class=True)

    # ---------------------------------------------------------------- predict
    def predict(self, task, datamodule, params=None, writer=None):
        """The predict loop (``predict``) over the datamodule's predict loader, at most
        ``limit_predict_batches`` batches; the predictions go to ``writer`` (the
        reference's BasePredictionWriter protocol), or are returned without one."""
        self._check_device(task)
        loader = datamodule.predict_dataloader()
        n = _limit(len(loader), self.pl.limit_predict_batches)
        out = predict(task, iter(loader), params=params, writer=writer, max_batches=n)
        self.last_predict_samples = out.samples
        self.last_predict_steady_samples = out.steady_samples
        self.last_predict_steady_time = out.steady_time
        self.predict_device_time = out.device_time
        self.predict_writer_time = out.writer_time
        return out.outputs


class _Mark:
    """A point on the device's timeline: a CUDA event on the current stream, or the
    host clock on the CPU.  ``seconds_to(later)`` waits for ``later``."""

    def __init__(self, device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record(torch.cuda.current_stream(device))
        else:
            self.t = time.perf_counter()

    def seconds_to(self, later: "_Mark") -> float:
        if self.event is None:
            return later.t - self.t
        later.event.synchronize()
        return self.event.elapsed_time(later.event) / 1e3
