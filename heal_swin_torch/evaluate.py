"""Evaluation entry point (the port's counterpart of ``heal_swin_tpu/evaluate.py``,
mirroring reference ``heal_swin/evaluate.py``).

Resolves the checkpoint from a run id / path (``utils.check_and_get_ckpt_paths``),
loads the saved model config from the run's artifacts, rebuilds the datamodule from
``eval_config.data_config``, builds the task on ``device`` (the first CUDA device when
None) and loads the checkpoint's state_dict into it, runs validate and/or predict, and
logs metrics INTO THE ORIGINAL TRAINING RUN (reference evaluate.py:92-96), under the
JAX entry's names and prefixes.  One process on one device, like the port's trainer.

    RUN_ID=<id> python3 -m heal_swin_torch.cli evaluate --config_path <config file>
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import numpy as np
import torch

from heal_swin_torch.data.data import get_data_module
from heal_swin_torch.evaluation.evaluate_config import EvaluateConfig
from heal_swin_torch.training import checkpoint as ckpt_lib
from heal_swin_torch.training.train_config import PLConfig
from heal_swin_torch.training.trainer import Trainer
from heal_swin_torch.utils import serialize, utils


def evaluate(eval_config: EvaluateConfig, pl_config: PLConfig, config_path: str = None,
             device=None):
    from heal_swin_torch.train import build_task

    ckpt_path, artifact_path, run_id = utils.check_and_get_ckpt_paths(
        eval_config.path, eval_config.epoch, eval_config.epoch_number
    )
    artifact_path = Path(artifact_path)

    serialize.save(eval_config, artifact_path / eval_config.eval_config_name)
    if config_path is not None and Path(config_path).exists():
        shutil.copy(config_path, artifact_path / Path(config_path).name)

    model_config = serialize.load(artifact_path / "model_config")

    datamodule, data_spec = get_data_module(eval_config.data_config)

    if eval_config.metric_prefix is None:
        if eval_config.epoch and eval_config.epoch.lower() == "number":
            epoch = "epoch=" + str(eval_config.epoch_number)
        elif run_id is None:
            epoch = Path(ckpt_path).name
        else:
            epoch = eval_config.epoch
        metric_prefix = "evaluate_" + epoch + "_"
    else:
        metric_prefix = eval_config.metric_prefix + "_"

    # metrics land in the original training run (reference evaluate.py:92-96)
    run = None
    if run_id is not None:
        from heal_swin_torch import tracking

        run = tracking.get_store().get_run(run_id)

    trainer = Trainer(pl_config, eval_config.train_config, run=run, device=device)
    task = build_task(model_config, data_spec, eval_config.data_config, device=trainer.device)
    state, _, _ = ckpt_lib.load_checkpoint(ckpt_path, map_location=trainer.device)
    task.model.load_state_dict(state, strict=True)
    del state

    if eval_config.log_masked_iou:
        _log_masked_iou(trainer, task, datamodule, metric_prefix, run)

    if eval_config.validate:
        # reference semantics: model.val_metrics_prefix prepends to the val_* names
        metrics = trainer.validate(task, datamodule, metrics_prefix=metric_prefix + "val_")
        print({k: round(v, 4) for k, v in metrics.items() if isinstance(v, float)})
        _log_throughput(run, metric_prefix + "val_samples_per_sec",
                        getattr(trainer, "last_eval_steady_samples", 0),
                        getattr(trainer, "last_eval_steady_time", 0.0), "validate")

    if eval_config.predict:
        writer = datamodule.get_pred_writer(
            eval_config.pred_writer,
            output_dir=artifact_path,
            output_resolution=eval_config.output_resolution,
            proj_res=eval_config.proj_res,
            prefix=metric_prefix,
            top_k=eval_config.top_k,
            ranking_metric=eval_config.ranking_metric,
            sort_dir=eval_config.sort_dir,
            run=run,
            device=trainer.device,  # the Chamfer writer's folds; the others take none
        )
        trainer.predict(task, datamodule, writer=writer)
        _log_throughput(run, metric_prefix + "predict_samples_per_sec",
                        getattr(trainer, "last_predict_steady_samples", 0),
                        getattr(trainer, "last_predict_steady_time", 0.0),
                        "predict+write")
        dev = getattr(trainer, "predict_device_time", 0.0)
        wrt = getattr(trainer, "predict_writer_time", 0.0)
        if run is not None and dev + wrt > 0:
            # device/host split of the predict phase (the device fetch overlaps
            # the NEXT batch's compute, so dev here is the un-hidden remainder)
            run.log_metrics({
                metric_prefix + "predict_device_blocked_sec": dev,
                metric_prefix + "predict_writer_host_sec": wrt,
            })

    print("Evaluation finished.")


def _log_throughput(run, name, n_samples, dt, phase):
    """Steady-state samples/s of an evaluation phase: the first batch is excluded."""
    if not n_samples or dt <= 0:
        return
    sps = n_samples / dt
    print(f"eval throughput [{phase}]: {int(n_samples)} samples in {dt:.1f}s "
          f"= {sps:.2f} samples/s (steady-state, first batch excluded)")
    if run is not None:
        run.log_metrics({name: sps})


def _log_masked_iou(trainer, task, datamodule, metric_prefix, run):
    """Masked (label != 0) IoU over the val set (reference ValMaskedIoULogger,
    logging_callbacks.py:235-264): {prefix}val_masked_iou[_ignored].  Each validation
    batch reaches the device through ``Trainer.device_val_batches`` (its
    ``device_batch_transform`` applied there) and goes through ``task.predict``; one batch
    in flight: batch i + 1's predict is queued on the device before batch i's classes
    are fetched and counted on the host."""
    from heal_swin_torch.evaluation import seg_metrics_np as m
    from heal_swin_torch.models.tasks import resolve_model

    model = resolve_model(task.model, None)
    iou = m.IoU(num_classes=task.num_classes, reduction="none")

    def consume(preds, masks):
        preds, masks = preds.cpu().numpy(), masks.cpu().numpy()
        keep = masks != 0
        iou.update(preds[keep], masks[keep])

    pending = None
    for imgs, masks in trainer.device_val_batches(datamodule):
        with torch.no_grad():
            preds = task.predict(model, imgs)
        if pending is not None:
            consume(*pending)
        pending = (preds, masks)
    if pending is not None:
        consume(*pending)
    ious = iou.compute()
    metrics = {
        f"{metric_prefix}val_masked_iou": float(np.mean(ious)),
        f"{metric_prefix}val_masked_iou_ignored": float(np.mean(ious[1:])),
    }
    if run is not None:
        run.log_metrics(metrics)
    print(metrics)


def main(argv=None):
    from heal_swin_torch.train import add_device_arg

    parser = add_device_arg(argparse.ArgumentParser())
    parser.add_argument("--config_path", required=True)
    args = parser.parse_args(argv)
    eval_config = utils.get_config_from_config_path(args.config_path, "get_eval_run_config")
    pl_config = utils.get_config_from_config_path(args.config_path, "get_pl_config")
    evaluate(eval_config, pl_config, args.config_path, device=args.device)


if __name__ == "__main__":
    main()
