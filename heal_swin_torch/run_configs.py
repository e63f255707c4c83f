"""The paper's run-config values for the port (the port's copy of the functions in the
repo's ``run_configs/_common.py`` and of the paper depth run config
``run_configs/depth_estimation/depth_swin_hp_train_run_config.py``, which import the JAX
package and so cannot run where the port runs): the HEAL-SWIN paper architecture, the
SynWoodScape-large class weights, the paper learning rate, and the depth run's model,
data and clipping settings.

The paper configs compute in float32 (the model config's ``dtype`` None) with
``drop_rate = attn_drop_rate = 0.1`` and the default ``drop_path_rate`` 0.1, and train
with Adam, batch 2 per device: segmentation at ``PAPER_LR``, depth at
``PAPER_DEPTH_LR`` with the masked l2 loss on standardized depths.
"""

from __future__ import annotations

from typing import NamedTuple

from heal_swin_torch.data.data_config import (WoodscapeCommonConfig,
                                              WoodscapeDepthCommonConfig,
                                              WoodscapeHPDepthConfig)
from heal_swin_torch.models.swin_hp import SwinHPTransformerConfig
from heal_swin_torch.models.tasks import CommonDepthConfig, WoodscapeDepthSwinHPConfig
from heal_swin_torch.training.optimizer import OptimizerConfig

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
