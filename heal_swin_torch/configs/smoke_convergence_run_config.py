"""Paper-scale convergence smoke (the port's copy of
``run_configs/smoke_tpu_convergence_run_config.py``): the full HEAL-SWIN-UNet (nside 256,
SwinUNet-T capacity -- reference
run_configs/segmentation/swin_hp_synwoodscape_large_train_run_config.py:35-92) in bf16,
trained on an auto-generated full-resolution (966x1280) synthetic WoodScape fixture
through the real input path (host decode -> prefetch loader -> on-device
fisheye->HEALPix projection) with the fused decoder tail.

    python3 -m heal_swin_torch.cli train --config_path heal_swin_torch/configs/smoke_convergence_run_config.py
    RUN_ID=<id> SMOKE_EPOCHS=<more> python3 -m heal_swin_torch.cli resume --config_path <this file>
    RUN_ID=<id> python3 -m heal_swin_torch.cli evaluate --config_path <this file>

Data lands under HEAL_SWIN_DATA_ROOT (default: heal_swin_smoke_data in the temporary
directory), the tracking FileStore under HEAL_SWIN_MLRUNS (default: mlruns there).
``eval_after_train`` is True, as in the JAX config: the fit is followed by validation
and the base writer's overlays at ``proj_res`` 966 in the same run (``evaluate_best_*``).
"""

import os
import tempfile
from pathlib import Path

N_PER_CAM = int(os.environ.get("SMOKE_N_PER_CAM", 8))  # 4 cams -> 25 train / 8 val imgs
MAX_EPOCHS = int(os.environ.get("SMOKE_EPOCHS", 20))  # 12 steps/epoch @ batch 2


def _root() -> Path:
    os.environ.setdefault("HEAL_SWIN_DATA_ROOT",
                          str(Path(tempfile.gettempdir()) / "heal_swin_smoke_data"))
    root = Path(os.environ["HEAL_SWIN_DATA_ROOT"])
    os.environ.setdefault("HEAL_SWIN_MLRUNS", str(root / "mlruns"))
    return root


def _ensure_fixture():
    from heal_swin_torch.data.synthetic_woodscape import generate

    root = _root()
    if not (root / "woodscape").exists():
        generate(root, version="woodscape", n_per_cam=N_PER_CAM, W=1280, H=966, seed=0)


def get_train_run_config():
    from heal_swin_torch.data.data_config import WoodscapeCommonConfig, WoodscapeHPConfig
    from heal_swin_torch.models.swin_hp import SwinHPTransformerConfig
    from heal_swin_torch.models.tasks import WoodscapeSegmenterSwinHPConfig
    from heal_swin_torch.training.optimizer import OptimizerConfig
    from heal_swin_torch.training.train_config import SingleModelTrainRun, TrainConfig

    _ensure_fixture()
    return SingleModelTrainRun(
        train=TrainConfig(
            mlflow_expmt="tpu_smoke",
            job_id="smoke_tpu_convergence",
            seed=42,
            eval_after_train=True,
        ),
        data=WoodscapeHPConfig(
            common=WoodscapeCommonConfig(
                version="woodscape",
                batch_size=2,
                val_batch_size=2,
                pred_batch_size=2,
                train_share=0.75,
            ),
            input_nside=256,
            input_base_pix=8,
            project_on_device=True,
        ),
        model=WoodscapeSegmenterSwinHPConfig(
            # paper model (reference swin_hp_synwoodscape_large_train_run_config.py)
            swin_hp_transformer_config=SwinHPTransformerConfig(
                patch_size=4,
                window_size=64,
                shift_size=4,
                shift_strategy="ring_shift",
                rel_pos_bias="flat",
                embed_dim=96,
                depths=[2, 2, 6, 2],
                num_heads=[3, 6, 12, 24],
                use_cos_attn=True,
                use_v2_norm_placement=True,
                dtype="bfloat16",
                gelu_approx=True,
            ),
            optimizer_config=OptimizerConfig(learning_rate=9.55e-4),
        ),
    )


def get_resume_run_config():
    """Resume run RUN_ID from its last checkpoint, with this file's train run config."""
    from heal_swin_torch.training.train_config import ResumeConfig

    return ResumeConfig(path=os.environ["RUN_ID"], epoch="last",
                        train_run_config=get_train_run_config())


def get_eval_run_config():
    """Headline-metric evaluation of run RUN_ID: validate plus the back-projection writer
    at proj_res 966 (the paper's ``back_projected_hp_masked_iou`` pipeline), logging the
    evaluation's throughput."""
    from heal_swin_torch.evaluation.evaluate_config import EvaluateConfig
    from heal_swin_torch.training.train_config import TrainConfig

    _ensure_fixture()
    cfg = get_train_run_config()
    return EvaluateConfig(
        path=os.environ["RUN_ID"],
        epoch="best",
        pred_writer="back_projected_hp_masked_iou",
        validate=True,
        predict=True,
        top_k=1,
        train_config=TrainConfig(mlflow_expmt="tpu_smoke"),
        data_config=cfg.data,
    )


def get_pl_config():
    from heal_swin_torch.training.train_config import PLConfig

    return PLConfig(
        max_epochs=MAX_EPOCHS,
        check_val_every_n_epoch=5,
        limit_val_batches=2,
        limit_predict_batches=2,  # >=2: the steady-state eval-throughput window
        # excludes the first batch
        log_every_n_steps=10**6,  # the loss is fetched at the epoch's end only
        num_sanity_val_steps=0,
    )
