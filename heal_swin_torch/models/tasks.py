"""Task modules (counterpart of ``heal_swin_tpu/models/tasks.py``): the HEALPix and the
flat SWIN-UNet's segmentation and depth tasks, each with ``loss_fn`` for training,
``predict`` for serving and its metrics, and the JAX package's registry of them
(``MODELS``, ``MODEL_FROM_CONFIG_NAME``, ...).

With ``fused_final_head`` the decoder tail runs fused: training hands the tokens after
``norm_up`` to the expand -> LN -> head -> loss kernels, which return the loss without
writing logits to be read back: weighted CE and the step's confusion matrix for
segmentation (K6 forward, K7 backward), the masked depth loss and the bf16
predictions for depth (K8 forward, K9 backward).  Segmentation predict hands the
tokens to the argmax kernel (K3); depth predict runs the unfused tail.  Each task takes
its fused route exactly where the JAX task's gate does: ``ops.final_head.supported``
(segmentation, loss and predict) and ``supported_depth`` (depth) on the
tokens of one sample, the model's embed width, the classes or output channels, the
patch and the compute dtype; elsewhere the unfused tail runs, as the JAX model runs
it.  A sample mask (eval padding, ``training.trainer``) sends the segmentation loss to
the unfused tail, as the JAX task's gate does (K6's confusion matrix counts every
element); the depth loss keeps its fused tail with the padded samples' targets set to
inf.  K3 and K6-K9 take bf16 and f32 tokens at every width the gates admit up to C
192 (``ops.final_head.kernels_take``); on the card a fused tail above it raises,
naming the kernel, and ``attention_impl="xla"`` runs the plain versions.  The flat segmentation task runs the
same tail kernels with p = p1 * p2 on targets rearranged into their row layout; the flat
depth task's tail is always unfused, as the JAX task's gate leaves it.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, field
from functools import partial
from typing import List, Optional

import torch
from torch import nn

from heal_swin_torch.data import normalize_depth_data as ndd
from heal_swin_torch.data.data_config import (  # noqa: F401 (re-exported for callers)
    WoodscapeDepthCommonConfig,
    WoodscapeDepthFlatConfig,
    WoodscapeHPDepthConfig,
)
from heal_swin_torch.data.data_spec import DataSpec, DepthDataSpec  # noqa: F401
from heal_swin_torch.evaluation import metrics as M
from heal_swin_torch.models.swin_flat import SwinTransformerConfig, SwinTransformerSys
from heal_swin_torch.models.swin_hp import SwinHPTransformerConfig, SwinHPTransformerSys
from heal_swin_torch.ops.final_head import (
    final_head_depth_loss,
    final_head_loss,
    final_head_predict,
    supported,
    supported_depth,
)
from heal_swin_torch.training import losses as L
from heal_swin_torch.training.losses import weighted_cross_entropy
from heal_swin_torch.training.optimizer import OptimizerConfig


def decoder_tail(model):
    """The fused decoder tail's operands in the JAX layout: expand weight (C, p*C), its
    LayerNorm's weight and bias, head weight (C, F).  The HP model keeps its tail in
    ``decoder``; the flat model at its top level (``up``, ``output``)."""
    if isinstance(model, SwinTransformerSys):
        return (model.up.expand.weight.t(), model.up.norm.weight, model.up.norm.bias,
                model.head_weight().t())
    dec = model.decoder
    return (dec.up.expand.weight.t(), dec.up.norm.weight, dec.up.norm.bias,
            dec.output.weight[:, :, 0].t())


def tail_patch(model) -> int:
    """The sub-pixels of a token in the decoder tail: p (HP), p1 * p2 (flat)."""
    p = model.config.patch_size
    return p[0] * p[1] if isinstance(p, tuple) else p


def resolve_model(model: SwinHPTransformerSys, params_or_module) -> SwinHPTransformerSys:
    """The network a ``predict`` call runs: ``params_or_module`` itself when it is an
    ``nn.Module``, ``model`` with a state_dict loaded into it, or ``model`` for None.
    Leaves it in eval mode."""
    if isinstance(params_or_module, nn.Module):
        model = params_or_module
    elif isinstance(params_or_module, Mapping):
        model.load_state_dict(params_or_module, strict=True)
    return model.eval()


@dataclass
class WoodscapeSegmenterSwinHPConfig:
    swin_hp_transformer_config: SwinHPTransformerConfig = field(
        default_factory=SwinHPTransformerConfig
    )
    optimizer_config: OptimizerConfig = field(default_factory=OptimizerConfig)
    class_weights: Optional[List[float]] = None


class WoodscapeSegmenterSwinHP:
    """HEAL-SWIN-UNet semantic segmentation.  ``self.model`` is the network, built on
    ``device`` (the first CUDA device when None; raises without one) from
    ``generator``."""

    CONFIG_CLASS = WoodscapeSegmenterSwinHPConfig
    NAME = "swin_hp"
    input_key = "hp_imgs"

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
        self.model = self._build_model(config, data_spec, device, generator)
        self.class_weights = torch.tensor(weights, dtype=torch.float32,
                                          device=self._device())

    @staticmethod
    def _build_model(config, data_spec, device, generator):
        return SwinHPTransformerSys(config.swin_hp_transformer_config, data_spec,
                                    device=device, generator=generator)

    def _device(self):
        return next(self.model.parameters()).device

    @staticmethod
    def _kernel_targets(model, targets):
        """Per-pixel targets (B, npix) -> the tail kernels' (B*T, p) rows: the p pixels
        of token n are the p column slices of its expand output."""
        p = tail_patch(model)
        return targets.reshape(-1, p)

    @staticmethod
    def _pred_from_kernel(model, preds, B):
        """The tail kernel's (B*T, p) classes -> the unfused predict shape (B, npix)."""
        return preds.reshape(B, -1)

    def _fused_geometry(self, model):
        """(tokens of one sample, sub-pixels of a token) of the decoder tail."""
        p = model.config.patch_size
        return self.data_spec.dim_in // p, p

    def _fused_tail_ok(self, model, sample_mask=None):
        """The JAX task's gate of the fused tail (loss and predict): the config flag on,
        no sample mask, and ``supported`` on one sample's tokens."""
        cfg = model.config
        if not cfg.fused_final_head or sample_mask is not None:
            return False
        T, p = self._fused_geometry(model)
        return supported(T, cfg.embed_dim, self.num_classes, p, cfg.compute_dtype)

    def loss_fn(self, imgs, targets, generator: Optional[torch.Generator] = None,
                deterministic: bool = True, sample_mask=None):
        """(B, npix, f_in) images and (B, npix) int targets -> (loss, outputs).

        ``deterministic=False`` runs the network in training mode, with the dropout
        masks drawn from ``generator``.  outputs are the step's (F, F) confusion matrix
        on the fused route (``fused_final_head`` without a sample mask), the (B, npix,
        F) logits otherwise; ``metric_update`` takes either.  ``sample_mask``: optional
        (B,) bool excluding padded samples from the loss (and, through
        ``metric_update``, from the metrics)."""
        model = self.model
        model.train(not deterministic)
        cfg = model.config
        device = self._device()
        imgs = torch.as_tensor(imgs, device=device)
        targets = torch.as_tensor(targets, device=device)
        if sample_mask is not None:
            sample_mask = torch.as_tensor(sample_mask, device=device)
        if self._fused_tail_ok(model, sample_mask):
            feats = model(imgs, tail=False, generator=generator)  # (B, N, C)
            B, N, C = feats.shape
            y = self._kernel_targets(model, targets).to(torch.int32)
            welem = self.class_weights[y.long()]
            return final_head_loss(feats.reshape(B * N, C), *decoder_tail(model), y, welem,
                                   patch_size=tail_patch(model), impl=cfg.attention_impl)
        logits = model(imgs, generator=generator)
        return weighted_cross_entropy(logits, targets, self.class_weights,
                                      sample_mask=sample_mask), logits

    @torch.no_grad()
    def predict(self, params_or_module, imgs) -> torch.Tensor:
        """(B, npix, f_in) images -> (B, npix) int32 class indices.

        ``params_or_module``: the network (an ``nn.Module``), a state_dict to load into
        ``self.model`` first, or None for ``self.model``.  Leaves the network in eval
        mode."""
        model = resolve_model(self.model, params_or_module)
        cfg = model.config
        device = next(model.parameters()).device
        imgs = torch.as_tensor(imgs, device=device)
        if not self._fused_tail_ok(model):
            return torch.argmax(model(imgs), dim=-1).to(torch.int32)
        feats = model(imgs, tail=False)  # (B, N, C) after norm_up, compute dtype
        B, N, C = feats.shape
        preds = final_head_predict(feats.reshape(B * N, C), *decoder_tail(model),
                                   patch_size=tail_patch(model), impl=cfg.attention_impl)
        return self._pred_from_kernel(model, preds, B)

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
        if sample_mask is not None:
            sample_mask = torch.as_tensor(sample_mask, device=preds.device)
        return M.seg_state_update(state, preds, torch.as_tensor(targets, device=preds.device),
                                  F, sample_mask)

    def metric_compute(self, state, prefix, with_per_class=False):
        return M.seg_state_compute(
            state, prefix, class_names=self.class_names if with_per_class else None)


@dataclass
class CommonDepthConfig:
    loss: str = "l2"  # "l2" | "l1" | "huber"
    use_logvar: bool = False
    train_uncertainty_after: int = -1
    huber_delta: float = 1.0


@dataclass
class WoodscapeDepthSwinHPConfig:
    swin_hp_transformer_config: SwinHPTransformerConfig = field(
        default_factory=SwinHPTransformerConfig
    )
    optimizer_config: OptimizerConfig = field(default_factory=OptimizerConfig)
    common_depth_config: CommonDepthConfig = field(default_factory=CommonDepthConfig)


class WoodscapeDepthSwinHP:
    """HEAL-SWIN-UNet depth estimation.  The network works in transformed and
    normalized depth space: ``loss_fn`` takes targets there (a non-finite value marks
    background), ``predict`` returns metric depths on channel 0, and the metrics run in
    metric space.  With ``use_logvar`` the head has a second, logvar channel.  The
    network is built on ``device`` as the segmentation task's.

    ``data_config``: a data config with a ``common_depth`` section (transform,
    normalization, background masking), as ``WoodscapeHPDepthConfig``; without one the
    network's space is metric depth."""

    CONFIG_CLASS = WoodscapeDepthSwinHPConfig
    NAME = "depth_swin_hp"
    input_key = "hp_imgs"

    def __init__(self, config: WoodscapeDepthSwinHPConfig, data_spec, data_config=None,
                 device=None, generator: Optional[torch.Generator] = None):
        self.config = config
        self.data_spec = data_spec
        self.data_config = data_config
        self.optimizer_config = config.optimizer_config
        self.cd = config.common_depth_config
        self.f_out = 2 if self.cd.use_logvar else 1
        self.model = self._build_model(config, data_spec.replace(f_out=self.f_out), device,
                                       generator)
        self.loss_impl = L.get_depth_loss(self.cd)
        self._epoch = 0
        self.dc = data_config.common_depth if data_config is not None else None
        # transform-space stats for the normalization; the metric-space mean for
        # RelSE / RelAE
        if getattr(data_spec, "data_stats", None) is not None:
            self.norm_stats = data_spec.data_stats
        elif self.dc is not None:
            self.norm_stats = ndd.get_depth_data_stats(self.dc.data_transform,
                                                       self.dc.mask_background)
        else:
            self.norm_stats = None
        mb = self.dc.mask_background if self.dc is not None else False
        self.metric_stats = ndd.get_depth_data_stats(None, mb)
        self.num_classes = None
        self.class_names = None

    @staticmethod
    def _build_model(config, data_spec, device, generator):
        return SwinHPTransformerSys(config.swin_hp_transformer_config, data_spec,
                                    device=device, generator=generator)

    def _device(self):
        return next(self.model.parameters()).device

    def _to_metric(self, out_ch0):
        """Network space -> metric depths: un-normalize, then invert the transform."""
        if self.dc is None:
            return out_ch0
        return ndd.unnormalize_and_retransform(out_ch0, self.dc.normalize_data,
                                               self.norm_stats, self.dc.data_transform)

    def _to_network(self, metric_depth):
        if self.dc is None:
            return metric_depth
        return ndd.transform_and_normalize(metric_depth, self.dc.normalize_data,
                                           self.norm_stats, self.dc.data_transform)

    def _loss_kind(self):
        """(kind, huber delta) of the fused kernels for the current loss, which
        ``set_epoch`` may switch to the NLL; (None, 1.0) for a loss they lack."""
        impl = self.loss_impl
        if impl is L.mean_log_var_loss:
            return "nll", 1.0
        if impl is L.mse:
            return "l2", 1.0
        if impl is L.l1_loss:
            return "l1", 1.0
        if isinstance(impl, partial) and impl.func is L.huber_loss:
            return "huber", float(impl.keywords.get("delta", 1.0))
        return None, 1.0

    def _fused_tail_ok(self):
        """The fused route (K8/K9) runs where the JAX task's does: the config asks for
        it, the loss has a kernel kind, and ``supported_depth`` admits one sample's
        tail."""
        cfg = self.model.config
        if not cfg.fused_final_head or self._loss_kind()[0] is None:
            return False
        T = self.data_spec.dim_in // cfg.patch_size
        return supported_depth(T, cfg.embed_dim, self.f_out, cfg.patch_size, cfg.compute_dtype)

    def loss_fn(self, imgs, targets, generator: Optional[torch.Generator] = None,
                deterministic: bool = True, sample_mask=None):
        """(B, npix, f_in) images and (B, npix) network-space targets -> (loss,
        outputs): the (B, npix, F) predictions, in the compute dtype on the fused route
        and f32 on the unfused one.  ``deterministic=False`` runs the network in
        training mode, with the dropout masks drawn from ``generator``.
        ``sample_mask``: optional (B,) bool; a padded sample's targets become inf, the
        losses' own exclusion."""
        model = self.model
        model.train(not deterministic)
        cfg = model.config
        device = self._device()
        imgs = torch.as_tensor(imgs, device=device)
        t = torch.as_tensor(targets, device=device).float()
        if sample_mask is not None:
            m = torch.as_tensor(sample_mask, device=device)
            m = m.reshape(m.shape + (1,) * (t.ndim - m.ndim))
            t = torch.where(m, t, float("inf"))
        if self._fused_tail_ok():
            feats = model(imgs, tail=False, generator=generator)  # (B, N, C)
            B, N, C = feats.shape
            p = cfg.patch_size
            kind, delta = self._loss_kind()
            loss, preds = final_head_depth_loss(
                feats.reshape(B * N, C), *decoder_tail(model), t.reshape(B * N, p),
                patch_size=p, loss_kind=kind, huber_delta=delta, impl=cfg.attention_impl)
            return loss, preds.reshape(B, N * p, self.f_out)
        out = model(imgs, generator=generator)
        return self.loss_impl(out, t), out

    @torch.no_grad()
    def predict(self, params_or_module, imgs) -> torch.Tensor:
        """(B, npix, f_in) images -> (B, npix, F) f32: metric depths on channel 0, a
        logvar channel left in network space.  ``params_or_module`` as the segmentation
        task's ``predict``."""
        model = resolve_model(self.model, params_or_module)
        imgs = torch.as_tensor(imgs, device=next(model.parameters()).device)
        out = model(imgs)
        ch0 = self._to_metric(out[..., :1])
        return torch.cat([ch0, out[..., 1:]], dim=-1)

    def set_epoch(self, epoch: int) -> bool:
        """Switch the loss to the NLL from epoch ``train_uncertainty_after`` on (with
        ``use_logvar``).  Returns True when the loss changed."""
        self._epoch = epoch
        tua = self.cd.train_uncertainty_after
        if (self.cd.use_logvar and isinstance(tua, int) and 0 < tua <= epoch
                and self.loss_impl is not L.mean_log_var_loss):
            self.loss_impl = L.mean_log_var_loss
            return True
        return False

    # --- metrics protocol ---
    def metric_init(self):
        return M.depth_state_init(device=self._device())

    @torch.no_grad()
    def metric_update(self, state, out, targets, sample_mask=None):
        """Metrics in metric space: predictions and targets both leave the network's
        space.  On the fused route the predictions are bf16 and leave it in bf16."""
        t = self._to_metric(torch.as_tensor(targets, device=out.device))
        if sample_mask is not None:
            m = torch.as_tensor(sample_mask, device=out.device)
            t = torch.where(m.reshape(m.shape + (1,) * (t.ndim - m.ndim)), t, float("inf"))
        log_var = out[..., 1] if self.cd.use_logvar and out.shape[-1] > 1 else None
        return M.depth_state_update(state, self._to_metric(out[..., 0]), t,
                                    dataset_mean=float(self.metric_stats.mean),
                                    log_var=log_var)

    def metric_compute(self, state, prefix, with_per_class=False):
        return M.depth_state_compute(state, prefix)


# ---------------------------------------------------------------------------
# The flat SWIN-UNet baseline (the JAX package's WoodscapeSegmenterSwin and
# WoodscapeDepthSwin)
# ---------------------------------------------------------------------------


@dataclass
class WoodscapeSegmenterSwinConfig:
    swin_transformer_config: SwinTransformerConfig = field(default_factory=SwinTransformerConfig)
    optimizer_config: OptimizerConfig = field(default_factory=OptimizerConfig)
    class_weights: Optional[List[float]] = None


class WoodscapeSegmenterSwin(WoodscapeSegmenterSwinHP):
    """The flat SWIN-UNet's semantic segmentation: (B, H, W, 3) images, (B, H, W)
    targets and classes.  The fused tail is the HP task's with p = p1 * p2: the flat
    tail is FinalPatchExpand2D -> LN -> head, the same (C, p1*p2*C) + (C,) + (C, F)
    math, and its depth-to-space only reorders pixels, which commutes with the
    per-element CE and confusion matrix; the targets are rearranged into the kernels'
    row layout instead, and the kernels' classes back (K6/K7 train, K3 predict).  The
    flat model is data-parallel only (no sequence sharding)."""

    CONFIG_CLASS = WoodscapeSegmenterSwinConfig
    NAME = "swin"
    input_key = "s2_imgs"

    @staticmethod
    def _build_model(config, data_spec, device, generator):
        return SwinTransformerSys(config.swin_transformer_config, data_spec, device=device,
                                  generator=generator)

    @staticmethod
    def _kernel_targets(model, targets):
        """(B, H, W) -> (B*Hp*Wp, p1*p2): token (h, w)'s sub-pixel (d1, d2) is column
        slice d1*p2 + d2 of its expand output."""
        p1, p2 = model.config.patch_size
        B, H, W = targets.shape
        t = targets.reshape(B, H // p1, p1, W // p2, p2).permute(0, 1, 3, 2, 4)
        return t.reshape(-1, p1 * p2)

    def _fused_geometry(self, model):
        p1, p2 = model.config.patch_size
        H, W = self.data_spec.dim_in
        return (H // p1) * (W // p2), p1 * p2

    @staticmethod
    def _pred_from_kernel(model, preds, B):
        """(B*Hp*Wp, p1*p2) -> (B, H, W)."""
        p1, p2 = model.config.patch_size
        H, W = model.data_spec.dim_in
        return preds.reshape(B, H // p1, W // p2, p1, p2).permute(0, 1, 3, 2, 4).reshape(B, H, W)


@dataclass
class WoodscapeDepthSwinConfig:
    swin_transformer_config: SwinTransformerConfig = field(default_factory=SwinTransformerConfig)
    optimizer_config: OptimizerConfig = field(default_factory=OptimizerConfig)
    common_depth_config: CommonDepthConfig = field(default_factory=CommonDepthConfig)


class WoodscapeDepthSwin(WoodscapeDepthSwinHP):
    """The flat SWIN-UNet's depth estimation: (B, H, W, 3) images, (B, H, W) targets,
    (B, H, W, F) predictions.  Its tail is always the unfused one: the JAX task's fused
    gate reads only ``swin_hp_transformer_config`` (``heal_swin_tpu/models/tasks.py``
    ``_DepthBase._fused_tail_ok``), so the flat depth step never runs K8/K9."""

    CONFIG_CLASS = WoodscapeDepthSwinConfig
    NAME = "depth_swin"
    input_key = "s2_imgs"

    @staticmethod
    def _build_model(config, data_spec, device, generator):
        return SwinTransformerSys(config.swin_transformer_config, data_spec, device=device,
                                  generator=generator)

    def _fused_tail_ok(self):
        return False


# the JAX package's registry (``heal_swin_tpu/models/tasks.py``, reference
# models_lightning.py:12-34)
MODEL_CLASSES = [
    WoodscapeSegmenterSwin,
    WoodscapeSegmenterSwinHP,
    WoodscapeDepthSwin,
    WoodscapeDepthSwinHP,
]
MODELS = {m.NAME: m for m in MODEL_CLASSES}
MODEL_NAME_FROM_CONFIG_NAME = {m.CONFIG_CLASS.__name__: m.__name__ for m in MODEL_CLASSES}
MODEL_FROM_CONFIG_NAME = {m.CONFIG_CLASS.__name__: m for m in MODEL_CLASSES}
MODEL_FROM_NAME = {m.__name__: m for m in MODEL_CLASSES}
