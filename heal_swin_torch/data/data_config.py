"""The data configuration dataclasses the port uses (the port's copies of those in
``heal_swin_tpu/data/data_config.py``, mirroring reference
``heal_swin/data/data_config.py``): same fields and defaults, so one config drives
both packages.  ``version`` may name the synthetic test dataset ("synthetic") in
addition to the reference's woodscape variants, and ``synthetic_*`` knobs size it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Literal, Optional, Union


@dataclass
class DataCommonConfig:
    train_worker: int = 2
    val_worker: int = 2
    shuffle: bool = True
    batch_size: int = 32
    val_batch_size: int = 32
    pred_batch_size: int = 4
    manual_overfit_batches: int = 0
    training_data_fraction: float = 1.0
    data_fraction_seed: int = 42

    def __post_init__(self):
        assert 0.0 < self.training_data_fraction <= 1.0, "training_data_fraction not in (0.0, 1.0]"


@dataclass
class WoodscapeCommonConfig(DataCommonConfig):
    pred_samples: Union[int, float] = 10  # if float: fraction of val/train data
    rotate_pole: bool = False
    s2_bkgd_class: int = 0
    seed: Optional[int] = 42
    cam_pos: Optional[Literal["fv", "rv", "mvl", "mvr"]] = None
    train_share: float = 0.8
    crop_green: bool = False
    version: str = "woodscape"
    synthetic_train_samples: int = 16
    synthetic_val_samples: int = 8


@dataclass
class WoodscapeFlatConfig:
    common: WoodscapeCommonConfig = field(default_factory=WoodscapeCommonConfig)
    pred_part: Literal["train", "val"] = "val"
    input_width: int = 768
    input_height: int = 640
    padding: List[int] = field(default_factory=lambda: [0, 0, 0, 0])
    shuffle_train_val_split: bool = True
    nside: int = 256  # HP dataset used for projected predictions
    base_pix: int = 8


@dataclass
class WoodscapeHPConfig:
    common: WoodscapeCommonConfig = field(default_factory=WoodscapeCommonConfig)
    pred_part: Literal["train", "val"] = "val"
    input_nside: int = 256
    input_base_pix: int = 8
    shuffle_train_val_split: bool = True
    # project the flat inputs on the device (the datamodule's device_batch_transform)
    project_on_device: bool = False


@dataclass
class WoodscapeDepthCommonConfig:
    mask_background: bool = False
    data_transform: Optional[Literal["log", "inv", "None"]] = "None"
    normalize_data: Optional[Literal["standardize", "min-max", "None"]] = "None"


@dataclass
class WoodscapeDepthFlatConfig:
    common: WoodscapeCommonConfig = field(default_factory=WoodscapeCommonConfig)
    common_depth: WoodscapeDepthCommonConfig = field(default_factory=WoodscapeDepthCommonConfig)
    pred_part: Literal["train", "val"] = "val"
    input_width: int = 768
    input_height: int = 640
    padding: List[int] = field(default_factory=lambda: [0, 0, 0, 0])
    shuffle_train_val_split: bool = True
    nside: int = 256
    base_pix: int = 8


@dataclass
class WoodscapeHPDepthConfig:
    common: WoodscapeCommonConfig = field(default_factory=WoodscapeCommonConfig)
    common_depth: WoodscapeDepthCommonConfig = field(default_factory=WoodscapeDepthCommonConfig)
    pred_part: Literal["train", "val"] = "val"
    input_nside: int = 256
    input_base_pix: int = 8
    shuffle_train_val_split: bool = True
    # as WoodscapeHPConfig.project_on_device
    project_on_device: bool = False
