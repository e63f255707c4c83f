"""Task modules (counterpart of ``heal_swin_tpu/models/tasks.py``).

The HEALPix segmentation task: ``loss_fn`` for training, ``predict`` for serving and
the confusion-matrix metrics.  With ``fused_final_head`` the decoder tail runs fused:
training hands the tokens after ``norm_up`` to the expand -> LN -> head -> weighted
CE kernels (K6 forward, K7 backward), which return the loss and the step's confusion
matrix without writing logits; predict hands them to the argmax kernel (K3).
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import List, Optional

import torch
from torch import nn

from heal_swin_tpu.data.data_spec import DataSpec
from heal_swin_torch.evaluation import metrics as M
from heal_swin_torch.models.swin_hp import SwinHPTransformerConfig, SwinHPTransformerSys
from heal_swin_torch.ops.final_head import final_head_loss, final_head_predict
from heal_swin_torch.training.losses import weighted_cross_entropy
from heal_swin_torch.training.optimizer import OptimizerConfig


def decoder_tail(model: SwinHPTransformerSys):
    """The fused decoder tail's operands in the JAX layout: expand weight (C, p*C), its
    LayerNorm's weight and bias, head weight (C, F)."""
    dec = model.decoder
    return (dec.up.expand.weight.t(), dec.up.norm.weight, dec.up.norm.bias,
            dec.output.weight[:, :, 0].t())


@dataclass
class WoodscapeSegmenterSwinHPConfig:
    swin_hp_transformer_config: SwinHPTransformerConfig = field(
        default_factory=SwinHPTransformerConfig
    )
    optimizer_config: OptimizerConfig = field(default_factory=OptimizerConfig)
    class_weights: Optional[List[float]] = None


class WoodscapeSegmenterSwinHP:
    """HEAL-SWIN-UNet semantic segmentation.  ``self.model`` is the network, built on
    ``device`` from ``generator``."""

    def __init__(self, config: WoodscapeSegmenterSwinHPConfig, data_spec: DataSpec,
                 device=None, generator: Optional[torch.Generator] = None):
        self.config = config
        self.data_spec = data_spec
        self.optimizer_config = config.optimizer_config
        self.num_classes = data_spec.f_out
        self.class_names = data_spec.class_names or [str(c) for c in range(data_spec.f_out)]
        if config.class_weights is None:
            weights = [1.0] * data_spec.f_out
        else:
            if len(config.class_weights) != data_spec.f_out:
                raise ValueError(f"{len(config.class_weights)} class weights for "
                                 f"{data_spec.f_out} classes")
            weights = list(config.class_weights)
        self.model = SwinHPTransformerSys(config.swin_hp_transformer_config, data_spec,
                                          device=device, generator=generator)
        self.class_weights = torch.tensor(weights, dtype=torch.float32,
                                          device=self._device())

    def _device(self):
        return next(self.model.parameters()).device

    def loss_fn(self, imgs, targets, generator: Optional[torch.Generator] = None,
                deterministic: bool = True):
        """(B, npix, f_in) images and (B, npix) int targets -> (loss, outputs).

        ``deterministic=False`` runs the network in training mode, with the DropPath
        masks drawn from ``generator``.  outputs are the step's (F, F) confusion matrix
        on the fused route (``fused_final_head``), the (B, npix, F) f32 logits
        otherwise; ``metric_update`` takes either."""
        model = self.model
        model.train(not deterministic)
        cfg = model.config
        device = self._device()
        imgs = torch.as_tensor(imgs, device=device)
        targets = torch.as_tensor(targets, device=device)
        if cfg.fused_final_head:
            feats = model(imgs, tail=False, generator=generator)  # (B, N, C)
            B, N, C = feats.shape
            p = cfg.patch_size
            y = targets.reshape(B * N, p).to(torch.int32)  # the p pixels of each token
            welem = self.class_weights[y.long()]
            return final_head_loss(feats.reshape(B * N, C), *decoder_tail(model), y, welem,
                                   patch_size=p, impl=cfg.attention_impl)
        logits = model(imgs, generator=generator)
        return weighted_cross_entropy(logits, targets, self.class_weights), logits

    @torch.no_grad()
    def predict(self, params_or_module, imgs) -> torch.Tensor:
        """(B, npix, f_in) images -> (B, npix) int32 class indices.

        ``params_or_module``: the network (an ``nn.Module``), a state_dict to load into
        ``self.model`` first, or None for ``self.model``.  Leaves the network in eval
        mode."""
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
        preds = final_head_predict(feats.reshape(B * N, C), *decoder_tail(model),
                                   patch_size=cfg.patch_size, impl=cfg.attention_impl)
        return preds.reshape(B, -1)

    # --- metrics protocol ---
    def metric_init(self):
        return M.seg_state_init(self.num_classes, device=self._device())

    @torch.no_grad()
    def metric_update(self, state, outputs, targets, sample_mask=None):
        F = self.num_classes
        if outputs.ndim == 2 and tuple(outputs.shape) == (F, F):
            # fused route: outputs is the step's confusion matrix
            return M.seg_state_merge_confmat(state, outputs)
        preds = torch.argmax(outputs, dim=-1)
        return M.seg_state_update(state, preds, torch.as_tensor(targets, device=preds.device),
                                  F, sample_mask)

    def metric_compute(self, state, prefix, with_per_class=False):
        return M.seg_state_compute(
            state, prefix, class_names=self.class_names if with_per_class else None)
