"""Training entry point (the port's counterpart of ``heal_swin_tpu/train.py``, mirroring
reference ``heal_swin/train.py``).

``train_model(run_config, pl_config, config_path)`` builds the datamodule, task and
trainer, snapshots the configs into the run's artifacts (pickles + the verbatim config
file, reference train.py:122-146), logs the flattened hyperparameters with the
reference's prefixes (:219-227), optionally runs the learning-rate range test, fits, and
prints ``This run has id <id>`` (the string the reference's tests parse).

Differences from the JAX entry: one process on one device (``device``: the first CUDA
device when None; more than one process or device raises, ROADMAP queue 1 item 6), so
there is no exit barrier; ``model_flops`` is not logged (the FLOP counter is queue 1 item
7).  With ``eval_after_train`` the fit is followed by the JAX entry's in-process
evaluation (``evaluate.evaluate`` with a default ``EvaluateConfig``: validation and the
base writer at ``proj_res`` 966), its metrics in the same run under ``evaluate_best_``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import traceback
from pathlib import Path

import numpy as np

from heal_swin_torch.data.data import get_data_module
from heal_swin_torch.models import tasks
from heal_swin_torch.training.train_config import PLConfig, SingleModelTrainRun
from heal_swin_torch.training.trainer import Trainer
from heal_swin_torch.utils import serialize, utils


def get_effective_batch_size(run_config, pl_config, n_devices: int) -> int:
    """effective batch = batch * devices * nodes * accumulation (reference :34-41)."""
    accum = pl_config.accumulate_grad_batches
    accum = accum if isinstance(accum, int) else 1
    return run_config.data.common.batch_size * n_devices * pl_config.num_nodes * accum


def apply_precision(run_config: SingleModelTrainRun, pl_config: PLConfig):
    """Honor PLConfig.precision (reference Lightning AMP flag): 16 -> bfloat16 compute
    on the inner transformer config unless the config already pins a dtype."""
    if pl_config.precision not in (16, "16", "bf16", "bfloat16"):
        return run_config
    mc = run_config.model
    for field in ("swin_hp_transformer_config", "swin_transformer_config"):
        inner = getattr(mc, field, None)
        if inner is not None and inner.dtype is None:
            mc = dataclasses.replace(mc, **{field: dataclasses.replace(inner, dtype="bfloat16")})
    return dataclasses.replace(run_config, model=mc)


def save_config(artifacts_dir: Path, run_config, pl_config, task, data_spec, config_path=None):
    """Pickle the 6 config objects + copy the verbatim config file (reference :122-146)."""
    d = Path(artifacts_dir)
    serialize.save(run_config.train, d / "train_config")
    serialize.save(pl_config, d / "pl_config")
    serialize.save(run_config.model, d / "model_config")
    serialize.save(data_spec, d / "data_spec")
    serialize.save(run_config.data, d / "data_config")
    serialize.save(run_config, d / "run_config")
    if config_path is not None and Path(config_path).exists():
        shutil.copy(config_path, d / Path(config_path).name)


def build_task(model_config, data_spec, data_config, device=None):
    """The task of a model config (the JAX package's ``MODEL_FROM_CONFIG_NAME``) on
    ``device``; the depth tasks also take the data config."""
    task_cls = tasks.MODEL_FROM_CONFIG_NAME[type(model_config).__name__]
    if issubclass(task_cls, tasks.WoodscapeDepthSwinHP):
        return task_cls(model_config, data_spec, data_config, device=device)
    return task_cls(model_config, data_spec, device=device)


def _flax_module_name(key: str, flat: bool = False) -> str:
    """The JAX model's top-level module name of a state_dict key (the inverse of
    ``convert``'s key maps at the top level): the HP model nests its blocks
    (``layer0``, ``decoder``), the flat model names every block and stage part at the
    top (``layer0_block1``, ``downsample0``, ``upsample1``, ``patch_embed_proj``)."""
    parts = key.split(".")
    if flat:
        if parts[0] == "patch_embed":
            return f"patch_embed_{parts[1]}"
        if parts[0] in ("layers", "layers_up"):
            stage = "layer" if parts[0] == "layers" else "layer_up"
            if parts[0] == "layers_up" and parts[1] == "0":
                return "expand0"
            if parts[2] == "blocks":
                return f"{stage}{parts[1]}_block{parts[3]}"
            return f"{parts[2]}{parts[1]}"  # downsample{i} / upsample{k}
    else:
        if parts[0] == "layers":
            return f"layer{parts[1]}"
        if parts[0] == "layers_up":
            return "expand0" if parts[1] == "0" else f"layer_up{parts[1]}"
    if parts[0] == "concat_back_dim":
        return f"concat_back_dim{parts[1]}"
    return parts[0]


def param_counts(model) -> dict:
    """``total_params`` and ``total_params.<module>`` per top-level module, under the
    JAX model's module names (reference logging_callbacks.py:47-59)."""
    from heal_swin_torch.models.swin_flat import SwinTransformerSys

    flat = isinstance(model, SwinTransformerSys)
    out = {"total_params": sum(p.numel() for p in model.parameters())}
    for key, p in model.named_parameters():
        name = f"total_params.{_flax_module_name(key, flat)}"
        out[name] = out.get(name, 0) + p.numel()
    return out


def _check_single_process(pl_config: PLConfig):
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 or int(pl_config.num_nodes or 1) > 1 or (pl_config.num_devices() or 1) > 1:
        raise NotImplementedError(
            f"WORLD_SIZE={world}, num_nodes={pl_config.num_nodes}, gpus={pl_config.gpus!r}: "
            "the port's run entry trains in one process on one GPU; multi-GPU training is "
            "still to be ported (ROADMAP queue 1 item 6)")


def _lr_find_plot(path, lrs, losses, suggestion):
    """The range test's curve as a PNG, where matplotlib imports."""
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.plot(lrs, losses)
    ax.axvline(suggestion, color="red", ls="--", label=f"lr={suggestion:.2e}")
    ax.set_xscale("log")
    ax.set_xlabel("learning rate")
    ax.set_ylabel("smoothed loss")
    ax.legend()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def train_model(run_config: SingleModelTrainRun, pl_config: PLConfig, config_path=None,
                store=None, device=None):
    """Train a run config; returns (run id, ``FitResult``)."""
    run_config = apply_precision(run_config, pl_config)
    train_config = run_config.train
    _check_single_process(pl_config)

    if train_config.seed is not None:
        np.random.seed(train_config.seed)

    dm, data_spec = get_data_module(run_config.data)

    # a running tracking server (lockfile) captures the logging over HTTP, like the
    # reference's get_tracking_uri routing (mlflow_utils.py:8-19)
    from heal_swin_torch import tracking

    store = store or tracking.get_store()
    run = store.create_run(train_config.mlflow_expmt, run_name=train_config.job_id)
    print(f"This run has id {run.run_id}", flush=True)
    try:
        task = build_task(run_config.model, data_spec, run_config.data, device=device)
        trainer = Trainer(pl_config, train_config, run=run,
                          ckpt_dir=run.artifact_dir / "checkpoints", device=device)
        save_config(run.artifact_dir, run_config, pl_config, task, data_spec, config_path)

        if pl_config.auto_lr_find:
            # LR range test before the real fit (reference train.py:204-217 via the
            # Lightning tuner); replaces the configured lr and stores the sweep plot
            suggestion, lrs, losses = trainer.lr_find(task, dm)
            if suggestion is not None:
                task.optimizer_config = dataclasses.replace(
                    task.optimizer_config, learning_rate=suggestion)
                run.log_param("auto_lr_find.lr", suggestion)
                print(f"auto_lr_find suggested lr={suggestion:.3e}")
                _lr_find_plot(run.artifact_dir / "lr_find_plot.png", lrs, losses, suggestion)

        # hyperparameters with the reference's prefixes (train.py:219-227)
        params = {}
        params.update(serialize.flatten_config(train_config, "train."))
        params.update(serialize.flatten_config(run_config.model, "model."))
        params.update(serialize.flatten_config(run_config.data, "data."))
        params.update(serialize.flatten_config(data_spec, "data_spec."))
        params["batch_size"] = run_config.data.common.batch_size
        params["effective_batch_size"] = get_effective_batch_size(run_config, pl_config, 1)
        params["n_devices"] = 1
        run.log_params(params)
        run.set_tag("cmd", " ".join(sys.argv))
        if train_config.description:
            run.set_tag("mlflow.note.content", train_config.description)

        result = trainer.fit(task, dm)
        run.log_params(param_counts(task.model))

        if train_config.eval_after_train and not pl_config.fast_dev_run:
            # the full evaluation with a default EvaluateConfig, like the reference
            # (train.py:250-269); metrics land in this run with the evaluate_best_ prefix
            from heal_swin_torch.evaluate import evaluate
            from heal_swin_torch.evaluation.evaluate_config import EvaluateConfig

            eval_config = EvaluateConfig(path=run.run_id, epoch="best",
                                         data_config=run_config.data, train_config=train_config)
            evaluate(eval_config, pl_config, device=device)
        run.set_status("FINISHED")
        return run.run_id, result
    except BaseException:
        run.set_status("KILLED")
        traceback.print_exc()
        raise


def add_device_arg(parser):
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: the first CUDA device)")
    return parser


def main(argv=None):
    parser = add_device_arg(argparse.ArgumentParser())
    parser.add_argument("--config_path", required=True)
    args = parser.parse_args(argv)
    run_config = utils.get_config_from_config_path(args.config_path, "get_train_run_config")
    pl_config = utils.get_config_from_config_path(args.config_path, "get_pl_config")
    train_model(run_config, pl_config, config_path=args.config_path, device=args.device)


if __name__ == "__main__":
    main()
