"""Shared building blocks of the HEAL-SWIN models (counterpart of
``heal_swin_tpu/models/layers.py``).

Activations are channels-last; parameters are float32 and every product runs in the
activations' dtype (the compute dtype): ``linear`` casts the weights at use.
LayerNorm takes float32 statistics (eps 1e-5) and returns the input's dtype.
Parameter names follow the original torch HEAL-SWIN, so its state_dict keys apply.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from heal_swin_torch.ops import window_attention as wa

TRUNC_STD = 0.02


def trunc_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """The models' weight init: normal(0, 0.02) truncated to [-2, 2]."""
    return nn.init.trunc_normal_(w, std=TRUNC_STD, a=-2.0, b=2.0, generator=generator)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` applied in x's dtype (f32 parameters cast at use)."""
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5) with float32 statistics whose output keeps the input's
    dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth, scaled by 1/keep in training; identity at eval."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Mlp(nn.Module):
    """fc1 -> GELU (exact, or tanh with ``gelu_approx``) -> fc2, with dropout."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 drop: float = 0.0, gelu_approx: bool = False):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)
        self.approximate = "tanh" if gelu_approx else "none"
        self.drop = nn.Dropout(drop)

    def forward(self, x):
        x = F.gelu(linear(x, self.fc1), approximate=self.approximate)
        x = self.drop(x)
        return self.drop(linear(x, self.fc2))


class WindowAttention(nn.Module):
    """Multi-head self attention within windows of the nested token sequence.

    forward(x (B, nW, ws, C), groups (nW, ws) int32 or None, ln LayerNorm or None):
    tokens of different mask groups get an additive -100 logit; ``ln`` is the SWIN-v2
    res-post-norm, applied after the output projection.  Scaled-dot attention, or
    cosine attention with the logit scale exp(min(logit_scale, ln 100)).

    Routes (``attention_impl`` picks kernel or plain version; see
    ``heal_swin_torch.ops.window_attention``): cosine attention at C <= 384 runs the
    whole block -- qkv, attention, proj, LN -- as K1; otherwise qkv is one matmul, the
    attention runs as K2, and proj and LN stay plain torch.
    """

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, use_cos_attn: bool = False,
                 rel_pos_index: Optional[np.ndarray] = None, rel_pos_table_size: int = 0,
                 attention_impl: str = "auto"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.qk_scale = qk_scale
        self.attn_drop = attn_drop
        self.use_cos_attn = use_cos_attn
        self.attention_impl = attention_impl
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = nn.Dropout(proj_drop)
        if use_cos_attn:
            self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), float(np.log(10.0))))
        if rel_pos_index is not None:
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros(rel_pos_table_size, num_heads))
            self.register_buffer("rel_pos_index", torch.tensor(rel_pos_index, dtype=torch.long),
                                 persistent=False)
        else:
            self.relative_position_bias_table = None

    def forward(self, x, groups=None, ln: Optional[LayerNorm] = None):
        B, nW, ws, C = x.shape
        h = self.num_heads
        if self.attn_drop > 0.0 and self.training:
            raise NotImplementedError("attention dropout in training is not ported yet")
        rel_bias = None
        if self.relative_position_bias_table is not None:
            rel_bias = self.relative_position_bias_table[self.rel_pos_index]
            rel_bias = rel_bias.permute(2, 0, 1).float().contiguous()  # (h, ws, ws)
        ls = wa.clamped_logit_scale(self.logit_scale) if self.use_cos_attn else None
        has_mask = groups is not None
        groups_t = groups.repeat(B, 1) if has_mask else None
        sm_scale = self.qk_scale if self.qk_scale is not None else (C // h) ** -0.5
        x_flat = x.reshape(B * nW * ws, C)
        proj_dropout = self.training and self.proj_drop.p > 0.0
        if self.use_cos_attn and C <= wa.KERNEL_MAX_C and not proj_dropout:
            out = wa.window_attention_qkv_epi(
                x_flat, self.qkv.weight.t(), self.qkv.bias, self.proj.weight.t(),
                self.proj.bias, None if ln is None else ln.weight,
                None if ln is None else ln.bias, groups_t, rel_bias, ls, ws=ws,
                num_heads=h, sm_scale=sm_scale, has_mask=has_mask,
                impl=self.attention_impl)
        else:
            qkv = linear(x_flat, self.qkv)
            out = wa.window_attention(qkv, groups_t, rel_bias, ls, ws=ws, num_heads=h,
                                      use_cos=self.use_cos_attn, sm_scale=sm_scale,
                                      has_mask=has_mask, impl=self.attention_impl)
            out = self.proj_drop(linear(out, self.proj))
            if ln is not None:
                out = ln(out)
        return out.reshape(B, nW, ws, C)
