"""Evaluation configuration (the port's copy of
``heal_swin_tpu/evaluation/evaluate_config.py``; reference
heal_swin/evaluation/evaluate_config.py): same fields and defaults."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple, Union

from heal_swin_torch.data.data_config import WoodscapeFlatConfig
from heal_swin_torch.training.train_config import TrainConfig


@dataclass
class EvaluateConfig:
    path: str  # mlflow run_id or full path to a ckpt
    eval_config_name: str = "best"
    epoch: Optional[str] = "best"  # "best" | "last" | "number"
    epoch_number: Optional[str] = None
    metric_prefix: Optional[str] = None
    override_eval_config: bool = False
    pred_writer: Optional[str] = None
    validate: bool = True
    predict: bool = True
    proj_res: Union[int, Tuple[int, int]] = 966
    output_resolution: float = 0.5
    top_k: int = 5
    ranking_metric: str = "iou_ignored"  # "acc" | "iou" | "acc_ignored" | "iou_ignored" | "mse"
    sort_dir: str = "asc"
    log_masked_iou: bool = False
    train_config: TrainConfig = field(default_factory=TrainConfig)
    data_config: Any = field(default_factory=WoodscapeFlatConfig)
