"""The paper's run-config values for the port (the port's copy of the functions in the
repo's ``run_configs/_common.py`` and of the paper depth run configs
``run_configs/depth_estimation/depth_swin_hp_train_run_config.py`` and
``depth_swin_train_run_config.py``, which import the JAX package and so cannot run where
the port runs): the HEAL-SWIN and flat SWIN paper architectures, the SynWoodScape-large
class weights, the paper learning rate, the flat segmentation run, and the depth runs'
model, data and clipping settings.

The paper configs compute in float32 (the model config's ``dtype`` None) with
``drop_rate = attn_drop_rate = 0.1`` and the default ``drop_path_rate`` 0.1, and train
with Adam, batch 2 per device: segmentation at ``PAPER_LR``, depth at
``PAPER_DEPTH_LR`` with the masked l2 loss on standardized depths.
"""

from __future__ import annotations

import os
from typing import NamedTuple

from heal_swin_torch.data.data_config import (WoodscapeCommonConfig,
                                              WoodscapeDepthCommonConfig,
                                              WoodscapeDepthFlatConfig, WoodscapeFlatConfig,
                                              WoodscapeHPDepthConfig)
from heal_swin_torch.models.swin_flat import SwinTransformerConfig
from heal_swin_torch.models.swin_hp import SwinHPTransformerConfig
from heal_swin_torch.models.tasks import (CommonDepthConfig, WoodscapeDepthSwinConfig,
                                          WoodscapeDepthSwinHPConfig,
                                          WoodscapeSegmenterSwinConfig)
from heal_swin_torch.training.optimizer import OptimizerConfig
from heal_swin_torch.training.train_config import PLConfig, SingleModelTrainRun, TrainConfig

# class weights of the segmentation run configs (CE class balancing), 8 classes
SYNWOODSCAPE_LARGE_WEIGHTS = [
    0.62990112, 0.5111932, 0.88803174, 0.39921158,
    0.75032628, 0.88420746, 0.67315916, 0.43332322,
]

PAPER_LR = 0.000954993


def paper_swin_hp_config(**overrides) -> SwinHPTransformerConfig:
    """The HEAL-SWIN paper architecture (nside-independent): window 64, patch 4, shift
    4 by ``ring_shift``, flat rel-pos bias, embed 96, depths [2, 2, 6, 2], heads [3, 6,
    12, 24], cosine attention, v2 norm placement, dropout and attention dropout 0.1.
    ``overrides``: fields to set on top (``attention_impl``, for one)."""
    fields = dict(
        window_size=64, drop_rate=0.1, attn_drop_rate=0.1, patch_size=4, shift_size=4,
        embed_dim=96, depths=[2, 2, 6, 2], num_heads=[3, 6, 12, 24], mlp_ratio=4.0,
        qkv_bias=True, ape=False, use_cos_attn=True, use_v2_norm_placement=True,
        shift_strategy="ring_shift", rel_pos_bias="flat",
    )
    fields.update(overrides)
    return SwinHPTransformerConfig(**fields)


def paper_swin_flat_config(**overrides) -> SwinTransformerConfig:
    """The flat SWIN paper architecture (``run_configs/_common.py`` ``paper_swin_flat_config``;
    reference swin_synwoodscape_large_train_run_config.py:48-63): window 8 x 8, patch 2,
    shift 2, embed 96, depths [2, 2, 6, 2], heads [3, 6, 12, 24], cosine attention, v2
    norm placement, dropout and attention dropout 0.1.  ``overrides`` as in
    ``paper_swin_hp_config``."""
    fields = dict(
        window_size=8, drop_rate=0.1, attn_drop_rate=0.1, patch_size=2, shift_size=2,
        embed_dim=96, depths=[2, 2, 6, 2], num_heads=[3, 6, 12, 24], mlp_ratio=4.0,
        qkv_bias=True, ape=False, use_cos_attn=True, use_v2_norm_placement=True,
    )
    fields.update(overrides)
    return SwinTransformerConfig(**fields)


def job_id() -> str:
    return os.environ.get("SLURM_JOB_ID", "no_job_id")


def flat_seg_train_run(version="synwoodscape_large", expmt="synwoodscape_large",
                       class_weights=SYNWOODSCAPE_LARGE_WEIGHTS, training_data_fraction=1.0,
                       data_fraction_seed=42, **overrides) -> SingleModelTrainRun:
    """``run_configs/_common.py`` ``flat_seg_train_run``: the flat paper architecture
    (``overrides`` set on it), Adam at ``PAPER_LR`` without scheduler, the class
    weights, 640 x 768 inputs without padding, batch 2, validation and predict batches
    of 4, no early stopping or evaluation after the fit."""
    return SingleModelTrainRun(
        train=TrainConfig(job_id=job_id(), mlflow_expmt=expmt, description="swin-unet",
                          eval_after_train=False, early_stopping=False),
        data=WoodscapeFlatConfig(
            common=WoodscapeCommonConfig(
                version=version, batch_size=2, val_batch_size=4, pred_batch_size=4,
                train_worker=5, val_worker=5, training_data_fraction=training_data_fraction,
                data_fraction_seed=data_fraction_seed),
            input_width=768, input_height=640, padding=[0, 0, 0, 0]),
        model=WoodscapeSegmenterSwinConfig(
            swin_transformer_config=paper_swin_flat_config(**overrides),
            optimizer_config=OptimizerConfig(scheduler=None, learning_rate=PAPER_LR),
            class_weights=class_weights),
    )


def paper_pl_config() -> PLConfig:
    """``run_configs/_common.py`` ``paper_pl_config``: at most 1000 epochs on 4 GPUs (DDP),
    which the port's single-process entry refuses; a caller sets ``gpus``."""
    return PLConfig(max_epochs=1000, gpus=4, accelerator="ddp")


PAPER_DEPTH_LR = 0.005


class PaperDepthConfig(NamedTuple):
    """The paper depth run: the task's model config, its data config, and the trainer's
    gradient clipping (0: none)."""

    model: WoodscapeDepthSwinHPConfig
    data: WoodscapeHPDepthConfig
    gradient_clip_val: float


def paper_depth_config(**overrides) -> PaperDepthConfig:
    """The paper depth run config: the paper architecture (``overrides`` set on it, as
    in ``paper_swin_hp_config``), Adam at ``PAPER_DEPTH_LR`` without weight decay or
    scheduler, the l2 loss without a logvar channel, batch 2 at nside 256 on 8 base
    pixels, background masked, depths standardized and not transformed, no gradient
    clipping."""
    model = WoodscapeDepthSwinHPConfig(
        swin_hp_transformer_config=paper_swin_hp_config(**overrides),
        optimizer_config=OptimizerConfig(learning_rate=PAPER_DEPTH_LR, scheduler=None,
                                         weight_decay=0.0),
        common_depth_config=CommonDepthConfig(loss="l2", use_logvar=False,
                                              train_uncertainty_after=-1, huber_delta=1),
    )
    data = WoodscapeHPDepthConfig(
        common=WoodscapeCommonConfig(
            train_worker=5, val_worker=5, shuffle=True, batch_size=2, val_batch_size=4,
            pred_batch_size=4, manual_overfit_batches=0, pred_samples=10,
            rotate_pole=False, seed=42, cam_pos=None, train_share=0.8, crop_green=False,
            version="synwoodscape",
        ),
        common_depth=WoodscapeDepthCommonConfig(mask_background=True, data_transform=None,
                                                normalize_data="standardize"),
        pred_part="val", input_nside=256, input_base_pix=8, shuffle_train_val_split=True,
    )
    return PaperDepthConfig(model, data, 0)


def depth_swin_train_run(**overrides) -> SingleModelTrainRun:
    """The paper flat depth run config (``run_configs/depth_estimation/
    depth_swin_train_run_config.py``): ``paper_depth_config``'s optimizer, loss and data
    settings on the flat paper architecture (``overrides`` set on it) at 640 x 768,
    validated and checkpointed by ``val_mse``."""
    return SingleModelTrainRun(
        train=TrainConfig(
            ckpt_metric="val_mse", ckpt_mode="min",
            description="SWIN flat depth: lr 0.005, l2 loss, standardize, no transform",
            early_stopping=False, early_stopping_mode="min", early_stopping_monitor="val_mse",
            eval_after_train=False, job_id=job_id(), mlflow_expmt="depth_estimation"),
        data=WoodscapeDepthFlatConfig(
            common=WoodscapeCommonConfig(
                train_worker=5, val_worker=5, shuffle=True, batch_size=2, val_batch_size=4,
                pred_batch_size=4, manual_overfit_batches=0, pred_samples=10,
                rotate_pole=False, seed=42, cam_pos=None, train_share=0.8, crop_green=False,
                version="synwoodscape"),
            common_depth=WoodscapeDepthCommonConfig(mask_background=True, data_transform=None,
                                                    normalize_data="standardize"),
            pred_part="val", input_width=768, input_height=640, shuffle_train_val_split=True),
        model=WoodscapeDepthSwinConfig(
            swin_transformer_config=paper_swin_flat_config(**overrides),
            optimizer_config=OptimizerConfig(learning_rate=PAPER_DEPTH_LR, scheduler=None,
                                             weight_decay=0.0),
            common_depth_config=CommonDepthConfig(loss="l2", use_logvar=False,
                                                  train_uncertainty_after=-1, huber_delta=1)),
    )
