"""Shared building blocks of the HEAL-SWIN models (counterpart of
``heal_swin_tpu/models/layers.py``).

Activations are channels-last; parameters are float32 and every product runs in the
activations' dtype (the compute dtype): ``linear`` casts the weights at use.
LayerNorm takes float32 statistics (eps 1e-5) and returns the input's dtype; its
backward saves only the input, the row means and the row rstd (the JAX
package's ``_ln_fn``).  DropPath draws its per-sample masks from an explicit
``torch.Generator`` handed down the training forward, never from the global RNG;
element dropout (``Mlp``'s and ``WindowAttention``'s proj dropout) has no such
generator yet and raises in training.  Parameter names follow the original torch
HEAL-SWIN, so its state_dict keys apply.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from heal_swin_torch.ops import mlp as mlp_ops
from heal_swin_torch.ops import window_attention as wa

TRUNC_STD = 0.02


def trunc_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """The models' weight init: normal(0, 0.02) truncated to [-2, 2]."""
    return nn.init.trunc_normal_(w, std=TRUNC_STD, a=-2.0, b=2.0, generator=generator)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` applied in x's dtype (f32 parameters cast at use)."""
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), b)


class _LayerNormFn(torch.autograd.Function):
    """y = (x - mean) * rstd * weight + bias with f32 statistics, in x's dtype.

    Saves x in its own dtype with the per-row mean and rstd (not the f32 upcast that
    autograd through ``x.float()`` would keep), and recomputes x_hat in the backward:
    dx = rstd * (g - mean(g) - x_hat * mean(g * x_hat)) for g = dy * weight, as
    ``heal_swin_tpu.models.layers._ln_bwd`` (ATen's layer-norm backward evaluates the
    same formula)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        shape = (x.shape[-1],)
        y, mean, rstd = torch.native_layer_norm(x.float(), shape, weight.float(),
                                                bias.float(), eps)
        ctx.save_for_backward(x, mean, rstd, weight, bias)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd, weight, bias = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw, db = torch.ops.aten.native_layer_norm_backward(
            dy.float(), x.float(), (x.shape[-1],), mean, rstd, weight.float(), bias.float(),
            [need[0], need[1], need[2]])
        return (None if dx is None else dx.to(x.dtype), dw, db, None)


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5) with float32 statistics whose output keeps the input's
    dtype."""

    def forward(self, x):
        return _LayerNormFn.apply(x, self.weight, self.bias, self.eps)


class DropPath(nn.Module):
    """Per-sample stochastic depth, scaled by 1/keep in training; identity at eval.
    In training the masks come from ``generator`` (on the activations' device)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.rate == 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError("DropPath in training needs an explicit torch.Generator")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Mlp(nn.Module):
    """fc1 -> GELU (exact, or tanh with ``gelu_approx``) -> fc2.

    ``mlp_impl`` (the JAX module's field): "xla", the plain dense route; "fused",
    ``ops.mlp.fused_mlp_nd`` (the same forward, backward K13) where ``out_features``
    equals the input width and ``ops.mlp.supported`` takes the shape, else the plain
    route.  K13 takes bfloat16 only, so a CUDA input of another dtype that passes the
    gate raises at the call.  Element dropout in training (``drop`` > 0), which sends the JAX module to
    its plain route, is not ported yet and raises: its masks would need an explicit
    generator, as DropPath has."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 drop: float = 0.0, gelu_approx: bool = False, mlp_impl: str = "xla"):
        super().__init__()
        if mlp_impl not in ("xla", "fused"):
            raise ValueError(f"unknown mlp_impl {mlp_impl!r}: expected 'xla' or 'fused'")
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)
        self.gelu_approx = gelu_approx
        self.drop = float(drop)
        self.mlp_impl = mlp_impl

    def forward(self, x):
        if self.drop > 0.0 and self.training:
            raise NotImplementedError("element dropout in training is not ported yet")
        C = x.shape[-1]
        if (self.mlp_impl == "fused" and self.fc2.out_features == C
                and mlp_ops.supported(x.numel() // C, C, self.fc1.out_features)):
            return mlp_ops.fused_mlp_nd(x, self.fc1.weight.t(), self.fc1.bias,
                                        self.fc2.weight.t(), self.fc2.bias,
                                        approximate=self.gelu_approx)
        x = F.gelu(linear(x, self.fc1), approximate="tanh" if self.gelu_approx else "none")
        return linear(x, self.fc2)


class WindowAttention(nn.Module):
    """Multi-head self attention within windows of the nested token sequence.

    forward(x (B, nW, ws, C), groups (nW, ws) int32 or None, ln LayerNorm or None):
    tokens of different mask groups get an additive -100 logit; ``ln`` is the SWIN-v2
    res-post-norm, applied after the output projection.  Scaled-dot attention, or
    cosine attention with the logit scale exp(min(logit_scale, ln 100)).

    Routes, as the JAX module's Pallas plan (``attention_impl`` picks kernel or plain
    version; on the card "auto" runs the route's kernel and raises where
    ``ops.window_attention.kernels_take`` says the kernel does not take the operands,
    and "xla" runs the plain versions): at C <= 384 the weights
    are cast to the compute dtype first, so their gradients round there as in the JAX
    package, and cosine attention runs the whole block -- qkv, attention, proj, LN --
    as K1 (backward K4), scaled-dot attention the qkv projection and the attention as
    K16 (backward K17) with proj and LN plain torch after it; above C = 384 qkv is one
    matmul, the attention runs as K2 (backward K5), and proj and LN stay plain torch.
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
        self.proj_drop = float(proj_drop)
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
        if self.proj_drop > 0.0 and self.training:
            raise NotImplementedError("element dropout in training is not ported yet")
        rel_bias = None
        if self.relative_position_bias_table is not None:
            rel_bias = self.relative_position_bias_table[self.rel_pos_index]
            rel_bias = rel_bias.permute(2, 0, 1).float().contiguous()  # (h, ws, ws)
        ls = wa.clamped_logit_scale(self.logit_scale) if self.use_cos_attn else None
        has_mask = groups is not None
        groups_t = groups.repeat(B, 1) if has_mask else None
        sm_scale = self.qk_scale if self.qk_scale is not None else (C // h) ** -0.5
        x_flat = x.reshape(B * nW * ws, C)
        kw = dict(ws=ws, num_heads=h, sm_scale=sm_scale, has_mask=has_mask,
                  impl=self.attention_impl)
        if C <= wa.KERNEL_MAX_C:
            dt = x.dtype
            wq = self.qkv.weight.to(dt).t()
            bq = None if self.qkv.bias is None else self.qkv.bias.to(dt)
            if self.use_cos_attn:
                out = wa.window_attention_qkv_epi(
                    x_flat, wq, bq, self.proj.weight.to(dt).t(), self.proj.bias.to(dt),
                    None if ln is None else ln.weight, None if ln is None else ln.bias,
                    groups_t, rel_bias, ls, **kw)
                return out.reshape(B, nW, ws, C)
            out = wa.window_attention_qkv(x_flat, wq, bq, groups_t, rel_bias, None,
                                          use_cos=False, **kw)
        else:
            out = wa.window_attention(linear(x_flat, self.qkv), groups_t, rel_bias, ls,
                                      use_cos=self.use_cos_attn, **kw)
        out = linear(out, self.proj)
        if ln is not None:
            out = ln(out)
        return out.reshape(B, nW, ws, C)
