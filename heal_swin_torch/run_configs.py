"""The paper's run-config values for the port (the port's copy of the functions in the
repo's ``run_configs/_common.py``, which import the JAX package and so cannot run where
the port runs): the HEAL-SWIN paper architecture, the SynWoodScape-large class weights
and the paper learning rate.

The paper configs compute in float32 (the model config's ``dtype`` None) with
``drop_rate = attn_drop_rate = 0.1`` and the default ``drop_path_rate`` 0.1, and train
with Adam at ``PAPER_LR``, batch 2 per device.
"""

from __future__ import annotations

from heal_swin_torch.models.swin_hp import SwinHPTransformerConfig

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
