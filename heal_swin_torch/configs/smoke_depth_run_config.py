"""Paper-scale depth smoke (the port's copy of ``run_configs/smoke_tpu_depth_run_config.py``):
HEAL-SWIN depth estimation (nside 256, paper capacity, f32, l2 loss, standardize
normalization -- reference run_configs/depth_estimation/depth_swin_hp_train_run_config.py:14-135)
trained on an auto-generated full-resolution (966x1280) synthetic SynWoodScape fixture
with depth maps, through the on-device projection input path.

    python3 -m heal_swin_torch.cli train --config_path heal_swin_torch/configs/smoke_depth_run_config.py
    RUN_ID=<id> python3 -m heal_swin_torch.cli evaluate --config_path <this file>

Data lands under HEAL_SWIN_DATA_ROOT (default: heal_swin_smoke_depth in the temporary
directory), the tracking FileStore under HEAL_SWIN_MLRUNS (default: mlruns there).
"""

import os
import tempfile
from pathlib import Path

N_PER_CAM = int(os.environ.get("SMOKE_N_PER_CAM", 8))  # 4 cams -> 25 train / 8 val
MAX_EPOCHS = int(os.environ.get("SMOKE_EPOCHS", 8))  # 12 steps/epoch @ batch 2


def _root() -> Path:
    os.environ.setdefault("HEAL_SWIN_DATA_ROOT",
                          str(Path(tempfile.gettempdir()) / "heal_swin_smoke_depth"))
    root = Path(os.environ["HEAL_SWIN_DATA_ROOT"])
    os.environ.setdefault("HEAL_SWIN_MLRUNS", str(root / "mlruns"))
    return root


def _ensure_fixture():
    from heal_swin_torch.data.synthetic_woodscape import generate

    root = _root()
    if not (root / "synwoodscape").exists():
        generate(root, version="synwoodscape", n_per_cam=N_PER_CAM, W=1280, H=966,
                 seed=0, with_depth=True)


def _data_config():
    from heal_swin_torch.data.data_config import (
        WoodscapeCommonConfig,
        WoodscapeDepthCommonConfig,
        WoodscapeHPDepthConfig,
    )

    return WoodscapeHPDepthConfig(
        common=WoodscapeCommonConfig(
            version="synwoodscape",
            batch_size=2,
            val_batch_size=2,
            pred_batch_size=2,
            pred_samples=4,
            train_share=0.75,
        ),
        common_depth=WoodscapeDepthCommonConfig(
            mask_background=True, data_transform=None, normalize_data="standardize",
        ),
        input_nside=256,
        input_base_pix=8,
        project_on_device=True,
    )


def get_train_run_config():
    from heal_swin_torch.models.tasks import CommonDepthConfig, WoodscapeDepthSwinHPConfig
    from heal_swin_torch.run_configs import paper_swin_hp_config
    from heal_swin_torch.training.optimizer import OptimizerConfig
    from heal_swin_torch.training.train_config import SingleModelTrainRun, TrainConfig

    _ensure_fixture()
    return SingleModelTrainRun(
        train=TrainConfig(
            mlflow_expmt="tpu_smoke_depth",
            job_id="smoke_tpu_depth",
            seed=42,
            ckpt_metric="val_mse",
            ckpt_mode="min",
            eval_after_train=False,  # the Chamfer evaluation runs on its own
        ),
        data=_data_config(),
        model=WoodscapeDepthSwinHPConfig(
            swin_hp_transformer_config=paper_swin_hp_config(),
            optimizer_config=OptimizerConfig(learning_rate=0.005, scheduler=None,
                                             weight_decay=0.0),
            common_depth_config=CommonDepthConfig(
                loss="l2", use_logvar=False, train_uncertainty_after=-1, huber_delta=1
            ),
        ),
    )


def get_eval_run_config():
    """The Chamfer evaluation of run RUN_ID: validate plus the Chamfer writer."""
    from heal_swin_torch.evaluation.evaluate_config import EvaluateConfig
    from heal_swin_torch.training.train_config import TrainConfig

    _ensure_fixture()
    return EvaluateConfig(
        path=os.environ["RUN_ID"],
        epoch="best",
        pred_writer="chamfer_distance",
        validate=True,
        predict=True,
        top_k=1,
        ranking_metric="mse",
        sort_dir="asc",
        train_config=TrainConfig(mlflow_expmt="tpu_smoke_depth"),
        data_config=_data_config(),
    )


def get_pl_config():
    from heal_swin_torch.training.train_config import PLConfig

    return PLConfig(
        max_epochs=MAX_EPOCHS,
        check_val_every_n_epoch=4,
        limit_val_batches=2,
        limit_predict_batches=2,
        log_every_n_steps=10**6,
        num_sanity_val_steps=0,
    )
