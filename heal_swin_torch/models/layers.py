"""Shared building blocks of the HEAL-SWIN models (counterpart of
``heal_swin_tpu/models/layers.py``).

Activations are channels-last; parameters are float32 and every product runs in the
activations' dtype (the compute dtype): ``linear`` casts the weights at use.
LayerNorm takes float32 statistics (eps 1e-5) and returns the input's dtype; its
backward saves only the input, the row means and the row rstd (the JAX
package's ``_ln_fn``).  DropPath's per-sample masks and element dropout's
(``Dropout``: the model's ``pos_drop``, ``Mlp``'s, ``WindowAttention``'s attention and
proj dropout) are drawn from an explicit ``torch.Generator`` handed down the training
forward, never from the global RNG, through ``keep_mask``, in the order the modules
run.  Parameter names follow the original torch HEAL-SWIN, so its state_dict keys
apply.
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


def reset_parameters(model: nn.Module, generator: torch.Generator,
                     ape: Optional[torch.Tensor] = None) -> None:
    """The JAX package's init of a SWIN-UNet: trunc-normal(0.02) weights (linear and
    convolution), zero biases, LN ones and zeros, logit scale ln 10, relative-position
    tables zeros or trunc-normal (``WindowAttention.rel_pos_init_zero``), and ``ape``
    trunc-normal.  The draws are made on the CPU from ``generator`` (a CPU generator),
    in module order, and copied in, so that a seed gives the same weights wherever the
    network lives."""

    def draw(w):
        w.copy_(trunc_normal_(torch.empty(w.shape, dtype=w.dtype), generator))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                draw(m.weight)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, WindowAttention):
                if m.use_cos_attn:
                    m.logit_scale.fill_(float(np.log(10.0)))
                if m.relative_position_bias_table is not None:
                    if m.rel_pos_init_zero:
                        m.relative_position_bias_table.zero_()
                    else:
                        draw(m.relative_position_bias_table)
        if ape is not None:
            draw(ape)


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


def keep_mask(shape, keep: float, generator: torch.Generator, device) -> torch.Tensor:
    """A bool mask of ``shape`` on ``device``, each entry kept (True) with probability
    ``keep``: uniform draws from ``generator`` below ``keep``.  Every dropout mask of
    the models comes from here, one call per mask in the order the modules run."""
    return torch.rand(shape, generator=generator, device=device) < keep


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
        mask = keep_mask((x.shape[0],) + (1,) * (x.ndim - 1), keep, generator, x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Dropout(nn.Module):
    """Element dropout as flax's ``nn.Dropout``: in training each entry is kept with
    probability 1 - rate and scaled by 1 / (1 - rate), ``where(keep, x / keep_prob,
    0)`` in x's dtype, the mask drawn from ``generator`` (``keep_mask``); the identity
    at eval or at rate 0, drawing nothing.  In training with rate > 0 and no generator
    it raises, as DropPath does."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.rate == 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError("Dropout in training needs an explicit torch.Generator")
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        return torch.where(keep_mask(x.shape, keep, generator, x.device), x / keep,
                           torch.zeros_like(x))


class Mlp(nn.Module):
    """fc1 -> GELU (exact, or tanh with ``gelu_approx``) -> dropout -> fc2 -> dropout.

    ``mlp_impl`` (the JAX module's field): "xla", the plain dense route; "fused",
    ``ops.mlp.fused_mlp_nd`` (the same forward, backward K13) where ``out_features``
    equals the input width and ``ops.mlp.supported`` takes the shape, else the plain
    route.  K13 takes bfloat16 (and float32, through its f32 kernel), so a CUDA input
    of another dtype that passes the gate raises at the call.  Element dropout in training (``drop`` > 0) follows the
    GELU and fc2, as the JAX module's, its masks from ``generator``; active, it sends
    ``mlp_impl="fused"`` to the plain route, as it does the JAX module."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 drop: float = 0.0, gelu_approx: bool = False, mlp_impl: str = "xla"):
        super().__init__()
        if mlp_impl not in ("xla", "fused"):
            raise ValueError(f"unknown mlp_impl {mlp_impl!r}: expected 'xla' or 'fused'")
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)
        self.gelu_approx = gelu_approx
        self.drop = float(drop)
        self.dropout = Dropout(drop)
        self.mlp_impl = mlp_impl

    def forward(self, x, generator: Optional[torch.Generator] = None):
        C = x.shape[-1]
        dropout_active = self.drop > 0.0 and self.training
        if (self.mlp_impl == "fused" and not dropout_active and self.fc2.out_features == C
                and mlp_ops.supported(x.numel() // C, C, self.fc1.out_features)):
            return mlp_ops.fused_mlp_nd(x, self.fc1.weight.t(), self.fc1.bias,
                                        self.fc2.weight.t(), self.fc2.bias,
                                        approximate=self.gelu_approx)
        x = F.gelu(linear(x, self.fc1), approximate="tanh" if self.gelu_approx else "none")
        x = self.dropout(x, generator)
        return self.dropout(linear(x, self.fc2), generator)


class WindowAttention(nn.Module):
    """Multi-head self attention within windows of the nested token sequence.

    forward(x (B, nW, ws, C), groups (nW, ws) int32 or None, ln LayerNorm or None,
    generator): tokens of different mask groups get an additive -100 logit; ``ln`` is
    the SWIN-v2 res-post-norm, applied after the output projection.  Scaled-dot
    attention, or cosine attention with the logit scale exp(min(logit_scale, ln 100)).

    Routes, as the JAX module's ``_resolve_impl`` and ``__call__``:

    - Attention dropout active (``attn_drop`` > 0 in training): the JAX module's XLA
      branch (``_dense_route``) on any device: qkv linear, cosine or scaled scores in
      f32, rel-pos bias, mask, softmax in f32 cast to the compute dtype, dropout, the
      values, proj, proj dropout, LN.  No kernel runs; "pallas" raises, as the JAX
      module does.
    - Otherwise the Pallas plan (``_kernel_route``; ``attention_impl`` picks kernel or
      plain version: on the card "auto" runs the route's kernel and raises where
      ``ops.window_attention.kernels_take`` says the kernel does not take the operands,
      and "xla" runs the plain versions).  At C <= 384 the weights are cast to the
      compute dtype first, so their gradients round there as in the JAX package:
      cosine attention without active proj dropout runs the whole block -- qkv,
      attention, proj, LN -- as K1 (backward K4); scaled-dot attention, or cosine with
      proj dropout active, runs the qkv projection and the attention as K16 (backward
      K17) with proj, proj dropout and LN plain torch after it; above C = 384 qkv is
      one matmul, the attention runs as K2 (backward K5), and proj, proj dropout and
      LN stay plain torch.  Each of those kernels has a bf16 and an f32 form, forward
      and backward, so a bf16 or an f32 model trains and predicts through them alike.

    Dropout masks come from ``generator`` (``Dropout``).  ``rel_pos_init_zero``: the
    relative-position table's init, zeros (the HP model) or trunc-normal (the flat
    model); the models' ``reset_parameters`` reads it.
    """

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, use_cos_attn: bool = False,
                 rel_pos_index: Optional[np.ndarray] = None, rel_pos_table_size: int = 0,
                 rel_pos_init_zero: bool = True, attention_impl: str = "auto"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.qk_scale = qk_scale
        self.attn_drop = float(attn_drop)
        self.use_cos_attn = use_cos_attn
        self.attention_impl = attention_impl
        self.rel_pos_init_zero = rel_pos_init_zero
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = float(proj_drop)
        self.attn_dropout = Dropout(attn_drop)
        self.proj_dropout = Dropout(proj_drop)
        if use_cos_attn:
            self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), float(np.log(10.0))))
        if rel_pos_index is not None:
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros(rel_pos_table_size, num_heads))
            self.register_buffer("rel_pos_index", torch.tensor(rel_pos_index, dtype=torch.long),
                                 persistent=False)
        else:
            self.relative_position_bias_table = None

    def _rel_bias(self):
        """The (h, ws, ws) f32 relative-position bias, or None."""
        if self.relative_position_bias_table is None:
            return None
        rel_bias = self.relative_position_bias_table[self.rel_pos_index]
        return rel_bias.permute(2, 0, 1).float().contiguous()

    def forward(self, x, groups=None, ln: Optional[LayerNorm] = None,
                generator: Optional[torch.Generator] = None):
        if self.attn_drop > 0.0 and self.training:
            if self.attention_impl == "pallas":
                raise ValueError("attention_impl='pallas' unsupported here: active attention "
                                 "dropout runs the plain XLA route")
            return self._dense_route(x, groups, ln, generator)
        epi = self.use_cos_attn and not (self.proj_drop > 0.0 and self.training)
        return self._kernel_route(x, groups, ln, generator, epi)

    def _proj_out(self, out, ln, generator):
        """proj -> proj dropout -> the optional LayerNorm, on (T, C) or (..., C)."""
        out = self.proj_dropout(linear(out, self.proj), generator)
        return out if ln is None else ln(out)

    def _dense_route(self, x, groups, ln, generator):
        """The JAX module's XLA branch (``heal_swin_tpu/models/layers.py``
        ``WindowAttention.__call__``), attention dropout on the (B, nW, h, ws, ws)
        probabilities in the compute dtype."""
        B, nW, ws, C = x.shape
        h = self.num_heads
        hd = C // h
        qkv = linear(x, self.qkv).reshape(B, nW, ws, 3, h, hd)
        q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        if self.use_cos_attn:
            # rsqrt(max(sum_sq, eps)): finite gradients at an all-zero row
            qf, kf = q.float(), k.float()
            q = (qf * torch.rsqrt(torch.clamp_min((qf * qf).sum(-1, keepdim=True),
                                                  1e-24))).to(q.dtype)
            k = (kf * torch.rsqrt(torch.clamp_min((kf * kf).sum(-1, keepdim=True),
                                                  1e-24))).to(k.dtype)
            attn = torch.einsum("bwihd,bwjhd->bwhij", q.float(), k.float())
            attn = attn * torch.exp(torch.clamp_max(self.logit_scale.float(),
                                                    float(np.log(100.0))))
        else:
            scale = self.qk_scale if self.qk_scale is not None else hd ** -0.5
            attn = torch.einsum("bwihd,bwjhd->bwhij", (q * scale).float(), k.float())
        rel_bias = self._rel_bias()
        if rel_bias is not None:
            attn = attn + rel_bias
        if groups is not None:
            diff = groups[:, :, None] != groups[:, None, :]  # (nW, ws, ws)
            attn = attn + (diff.float() * wa.MASK_VALUE)[None, :, None]
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        attn = self.attn_dropout(attn, generator)
        out = torch.einsum("bwhij,bwjhd->bwihd", attn, v).reshape(B, nW, ws, C)
        return self._proj_out(out, ln, generator)

    def _kernel_route(self, x, groups, ln, generator, epi):
        """The JAX module's Pallas plan: with ``epi`` (cosine attention, no active proj
        dropout) K1 (K4) at C <= 384; else K16 (K17) at C <= 384 or K2 (K5) above, with
        plain proj, proj dropout and LN after it."""
        B, nW, ws, C = x.shape
        h = self.num_heads
        rel_bias = self._rel_bias()
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
            if epi:
                out = wa.window_attention_qkv_epi(
                    x_flat, wq, bq, self.proj.weight.to(dt).t(), self.proj.bias.to(dt),
                    None if ln is None else ln.weight, None if ln is None else ln.bias,
                    groups_t, rel_bias, ls, **kw)
                return out.reshape(B, nW, ws, C)
            out = wa.window_attention_qkv(x_flat, wq, bq, groups_t, rel_bias, ls,
                                          use_cos=self.use_cos_attn, **kw)
        else:
            out = wa.window_attention(linear(x_flat, self.qkv), groups_t, rel_bias, ls,
                                      use_cos=self.use_cos_attn, **kw)
        return self._proj_out(out, ln, generator).reshape(B, nW, ws, C)
