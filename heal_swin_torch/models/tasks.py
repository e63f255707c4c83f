"""Task modules (counterpart of ``heal_swin_tpu/models/tasks.py``).

This slice holds the HEALPix segmentation task's serving path: ``predict`` runs the
model without its tail and hands the tokens to the fused decoder-tail predict kernel
(K3), which emits the argmax class of every pixel without writing logits.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from heal_swin_tpu.data.data_spec import DataSpec
from heal_swin_torch.models.swin_hp import SwinHPTransformerConfig, SwinHPTransformerSys
from heal_swin_torch.ops.final_head import final_head_predict


@dataclass
class WoodscapeSegmenterSwinHPConfig:
    swin_hp_transformer_config: SwinHPTransformerConfig = field(
        default_factory=SwinHPTransformerConfig
    )


class WoodscapeSegmenterSwinHP:
    """HEAL-SWIN-UNet semantic segmentation.  ``self.model`` is the network, built on
    ``device`` from ``generator``."""

    def __init__(self, config: WoodscapeSegmenterSwinHPConfig, data_spec: DataSpec,
                 device=None, generator: Optional[torch.Generator] = None):
        self.config = config
        self.data_spec = data_spec
        self.num_classes = data_spec.f_out
        self.model = SwinHPTransformerSys(config.swin_hp_transformer_config, data_spec,
                                          device=device, generator=generator)

    @torch.no_grad()
    def predict(self, params_or_module, imgs) -> torch.Tensor:
        """(B, npix, f_in) images -> (B, npix) int32 class indices.

        ``params_or_module``: the network (an ``nn.Module``), a state_dict to load into
        ``self.model`` first, or None for ``self.model``."""
        model = self.model
        if isinstance(params_or_module, nn.Module):
            model = params_or_module
        elif isinstance(params_or_module, Mapping):
            model.load_state_dict(params_or_module, strict=True)
        model.eval()
        cfg = model.config
        device = next(model.parameters()).device
        imgs = torch.as_tensor(imgs, device=device)
        if not cfg.fused_final_head:
            return torch.argmax(model(imgs), dim=-1).to(torch.int32)
        feats = model(imgs, tail=False)  # (B, N, C) after norm_up, compute dtype
        B, N, C = feats.shape
        dec = model.decoder
        preds = final_head_predict(
            feats.reshape(B * N, C), dec.up.expand.weight.t(), dec.up.norm.weight,
            dec.up.norm.bias, dec.output.weight[:, :, 0].t(), patch_size=cfg.patch_size,
            impl=cfg.attention_impl)
        return preds.reshape(B, -1)
