"""Training configuration dataclasses (the port's copy of
``heal_swin_tpu/training/train_config.py``): the same fields and defaults, so one run
config drives both packages.

``PLConfig`` (alias ``TrainerConfig``) keeps the reference's pytorch-lightning Trainer
flags.  The port's ``Trainer`` honours the fields in ``HONORED_FIELDS`` and accepts the
rest, warning once a run about those set to a non-default value
(``warn_ignored_fields``).  It runs on one GPU: ``gpus`` above 1, ``num_nodes`` above 1
and ``seq_parallel_devices`` above 1 raise in ``Trainer.__init__`` (multi-GPU data and
sequence parallelism are still to be ported).
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from heal_swin_torch.data.data_config import WoodscapeHPConfig


@dataclass
class TrainConfig:
    """Reference train_config.py:21-38."""

    name: str = "train_config"
    job_id: str = "no_job_id"
    description: Optional[str] = None
    ckpt_metric: str = "val_iou_global_ignored"
    ckpt_mode: str = "max"
    eval_after_train: bool = True
    mlflow_expmt: str = "woodscape_tests"
    log_gpu_stats: bool = True
    early_stopping: bool = False
    early_stopping_monitor: str = "val_iou_global_ignored"
    early_stopping_mode: str = "max"
    early_stopping_patience: int = 10
    early_stopping_min_delta: float = 0.0
    seed: Optional[int] = None
    load_checkpoint: Optional[str] = None
    logging_step_offset: int = 0


@dataclass
class SingleModelTrainRun:
    """Bundle of train/data/model configs (reference train_config.py:41-50).
    ``model`` is one of the task config dataclasses of heal_swin_torch.models.tasks."""

    train: TrainConfig = field(default_factory=TrainConfig)
    data: Any = field(default_factory=WoodscapeHPConfig)
    model: Any = None  # default set lazily to WoodscapeSegmenterSwinHPConfig

    def __post_init__(self):
        if self.model is None:
            from heal_swin_torch.models.tasks import WoodscapeSegmenterSwinHPConfig

            self.model = WoodscapeSegmenterSwinHPConfig()


@dataclass
class ResumeConfig:
    """Reference train_config.py:53-58."""

    path: str  # MLflow run id or checkpoint path
    epoch: Optional[str] = "last"  # "best" | "last" | "number"
    epoch_number: Optional[str] = None
    train_run_config: SingleModelTrainRun = field(default_factory=SingleModelTrainRun)


@dataclass
class PLConfig:
    """Trainer flags, field-compatible with the reference PLConfig
    (train_config.py:61-112).

    - ``gpus``: the number of GPUs (a list or comma string: its length); the port's
      trainer runs on one.
    - ``precision``: 32 -> float32 compute, 16 -> bfloat16 compute.
    - honoured: the fields in ``HONORED_FIELDS``; ``deterministic`` is accepted as
      honoured: a run's dropout masks, data order and initial weights come from its seed.
    - ``seq_parallel_devices``: sequence-parallel shards per data-parallel group (the
      JAX package's extension); the port's trainer takes 1.
    """

    checkpoint_callback: bool = True
    default_root_dir: Optional[str] = None
    gradient_clip_val: float = 0.0
    gradient_clip_algorithm: str = "norm"
    process_position: int = 0
    num_nodes: int = 1
    num_processes: int = 1
    gpus: Optional[Union[List[int], str, int]] = None
    auto_select_gpus: bool = False
    tpu_cores: Optional[Union[List[int], str, int]] = None
    log_gpu_memory: Optional[str] = None
    progress_bar_refresh_rate: Optional[int] = None
    overfit_batches: Union[int, float] = 0.0
    track_grad_norm: Union[int, float, str] = -1
    check_val_every_n_epoch: int = 1
    fast_dev_run: Union[int, bool] = False
    accumulate_grad_batches: Union[int, Dict[int, int], List[list]] = 1
    max_epochs: Optional[int] = None
    min_epochs: Optional[int] = None
    max_steps: Optional[int] = None
    min_steps: Optional[int] = None
    max_time: Optional[Any] = None
    limit_train_batches: Union[int, float] = 1.0
    limit_val_batches: Union[int, float] = 1.0
    limit_test_batches: Union[int, float] = 1.0
    limit_predict_batches: Union[int, float] = 1.0
    val_check_interval: Union[int, float] = 1.0
    flush_logs_every_n_steps: int = 100
    log_every_n_steps: int = 50
    accelerator: Optional[str] = None
    sync_batchnorm: bool = False
    precision: int = 32
    weights_save_path: Optional[str] = None
    num_sanity_val_steps: int = 2
    truncated_bptt_steps: Optional[int] = None
    resume_from_checkpoint: Optional[str] = None
    benchmark: bool = False
    deterministic: bool = False
    reload_dataloaders_every_epoch: bool = False
    auto_lr_find: Union[bool, str] = False
    replace_sampler_ddp: bool = True
    terminate_on_nan: bool = False
    auto_scale_batch_size: Union[str, bool] = False
    prepare_data_per_node: bool = True
    amp_backend: str = "native"
    amp_level: str = "O2"
    distributed_backend: Optional[str] = None
    move_metrics_to_cpu: bool = False
    multiple_trainloader_mode: str = "max_size_cycle"
    stochastic_weight_avg: bool = False
    seq_parallel_devices: int = 1

    def num_devices(self) -> Optional[int]:
        """Resolve ``gpus`` to a device count (None -> all available)."""
        g = self.gpus
        if g is None:
            return None
        if isinstance(g, int):
            return None if g == 0 else g
        if isinstance(g, str):
            g = [s for s in g.split(",") if s.strip() != ""]
        return len(g) if len(g) > 0 else None


# the PLConfig fields a trainer consumes (the JAX package's set, kept whole so that
# one config warns alike in both packages; auto_lr_find is read by the run entry)
HONORED_FIELDS = frozenset({
    "checkpoint_callback", "gradient_clip_val", "check_val_every_n_epoch",
    "val_check_interval", "fast_dev_run", "accumulate_grad_batches",
    "max_epochs", "min_epochs", "max_steps", "limit_train_batches",
    "limit_val_batches", "limit_predict_batches", "log_every_n_steps",
    "precision", "num_sanity_val_steps", "resume_from_checkpoint",
    "terminate_on_nan", "auto_lr_find", "gpus", "num_nodes",
    "deterministic", "seq_parallel_devices",
})


def warn_ignored_fields(pl_config: PLConfig) -> List[str]:
    """Warn once about accepted-and-ignored PLConfig fields set to non-default
    values.  Returns the offending field names."""
    offending = [f.name for f in dataclasses.fields(pl_config)
                 if f.name not in HONORED_FIELDS and getattr(pl_config, f.name) != f.default]
    if offending:
        warnings.warn(
            "PLConfig fields accepted for reference-config compatibility but "
            f"IGNORED by the trainer were set to non-default values: "
            f"{', '.join(sorted(offending))} (honored fields: "
            "training/train_config.py HONORED_FIELDS)",
            stacklevel=2,
        )
    return offending


TrainerConfig = PLConfig
