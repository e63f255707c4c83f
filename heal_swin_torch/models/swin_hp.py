"""HEAL-SWIN-UNet in PyTorch: SWIN-UNet over the HEALPix grid in nested ordering
(counterpart of ``heal_swin_tpu/models/swin_hp.py``).

Tokens are nested-order HEALPix pixels treated as a flat sequence: windows are
contiguous runs (reshape), patch merging and expanding ride the 4-children-per-parent
nested hierarchy, and shifted windows are host-precomputed roll amounts or
permutations with mask group ids (``heal_swin_torch.ops.shifting``, numpy only).

Inputs (B, npix, f_in) channels-last; outputs (B, npix, f_out) float32, or with
``tail=False`` the (B, npix/p, C) tokens after ``norm_up`` in the compute dtype.  A
training forward takes an explicit ``torch.Generator`` for its dropout masks (DropPath,
``pos_drop`` and every block's attention, proj and MLP dropout), handed down to every
block; the masks are drawn in the order the modules run, so one generator state gives
one forward.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from heal_swin_torch.data.data_spec import DataSpec
from heal_swin_torch.models.layers import (
    DropPath,
    Dropout,
    LayerNorm,
    Mlp,
    WindowAttention,
    linear,
    trunc_normal_,
)
from heal_swin_torch.ops._dispatch import default_device
from heal_swin_torch.ops.permute import permute_tokens
from heal_swin_torch.ops.shifting import get_shift_spec
from heal_swin_torch.ops.windowing import get_nest_win_idcs


@dataclass
class SwinHPTransformerConfig:
    """The fields and defaults of ``heal_swin_tpu.models.swin_hp.SwinHPTransformerConfig``,
    so one config drives both packages.

    ``dtype``: compute dtype ("float32" | "bfloat16"); parameters stay float32.
    ``attention_impl``: "auto" runs the CUDA kernels for CUDA tensors and their plain
    versions for CPU tensors; "xla" runs the plain versions everywhere; "pallas"
    demands the kernels.  It governs every kernel of the model, the decoder tail's
    included.  ``fused_final_head``: predict through the fused expand+LN+head+argmax
    tail (K3) instead of the unfused tail and an argmax over the logits.
    """

    patch_size: int = 4
    window_size: int = 4
    shift_size: int = 2
    shift_strategy: str = "nest_roll"  # "nest_roll" | "nest_grid_shift" | "ring_shift"
    rel_pos_bias: Optional[str] = None  # None | "flat"
    embed_dim: int = 96
    patch_embed_norm_layer: Optional[str] = None  # None | "LayerNorm"
    depths: List[int] = field(default_factory=lambda: [2, 2, 2, 2])
    num_heads: List[int] = field(default_factory=lambda: [3, 6, 12, 24])
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    use_cos_attn: bool = False
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    norm_layer: str = "LayerNorm"
    use_v2_norm_placement: bool = False
    ape: bool = False
    patch_norm: bool = True
    use_checkpoint: bool = False
    dev_mode: bool = False
    decoder_class: str = "UnetDecoder"
    dtype: Optional[str] = None
    gelu_approx: bool = False
    attention_impl: str = "auto"
    fused_final_head: bool = True

    @property
    def compute_dtype(self) -> torch.dtype:
        return {None: torch.float32, "float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.dtype]


def _rel_pos_index_nested(window_size: int) -> np.ndarray:
    """(ws, ws) relative-position table index in nested token order: the 2-D SWIN
    index on the sqrt(ws) x sqrt(ws) grid, rows and columns permuted into nested
    order."""
    side = int(round(np.sqrt(window_size)))
    coords = np.stack(np.meshgrid(np.arange(side), np.arange(side), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += side - 1
    rel[:, :, 1] += side - 1
    rel[:, :, 0] *= 2 * side - 1
    idx = rel.sum(-1)
    nest_inv = np.argsort(get_nest_win_idcs(window_size).reshape(-1))
    return idx[nest_inv][:, nest_inv]


class SwinHPBlock(nn.Module):
    """One SWIN block on the nested pixel sequence at ``input_resolution`` tokens.

    The shift (roll or permutation), its inverse and the window mask groups are
    precomputed on the host and held as non-persistent buffers.  v2 norm placement
    hands ``norm1`` to the attention, which applies it after the projection (it is
    per-token, so it commutes with the inverse shift)."""

    def __init__(self, cfg: SwinHPTransformerConfig, dim: int, input_resolution: int,
                 base_pix: int, num_heads: int, shift_size: int, drop_path: float):
        super().__init__()
        self.input_resolution = input_resolution
        ws, shift = cfg.window_size, shift_size
        if input_resolution <= ws:  # one window covers the whole sequence
            ws, shift = input_resolution, 0
        self.window_size = ws
        self.v2 = cfg.use_v2_norm_placement
        spec = get_shift_spec(cfg.shift_strategy, input_resolution, base_pix, ws, shift)
        self.shift_kind = spec.kind
        self.roll_amount = spec.roll_amount
        perm = inv = groups = None
        if spec.kind == "perm":
            perm = torch.tensor(spec.perm, dtype=torch.long)
            inv = torch.tensor(spec.inv_perm, dtype=torch.long)
        if spec.win_groups is not None:
            groups = torch.tensor(spec.win_groups, dtype=torch.int32)
        self.register_buffer("perm", perm, persistent=False)
        self.register_buffer("inv_perm", inv, persistent=False)
        self.register_buffer("win_groups", groups, persistent=False)

        side = int(round(np.sqrt(ws)))
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(
            dim, num_heads, qkv_bias=cfg.qkv_bias, qk_scale=cfg.qk_scale,
            attn_drop=cfg.attn_drop_rate, proj_drop=cfg.drop_rate,
            use_cos_attn=cfg.use_cos_attn,
            rel_pos_index=_rel_pos_index_nested(ws) if cfg.rel_pos_bias == "flat" else None,
            rel_pos_table_size=(2 * side - 1) ** 2, attention_impl=cfg.attention_impl)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio), dim, drop=cfg.drop_rate,
                       gelu_approx=cfg.gelu_approx)
        self.drop_path = DropPath(drop_path)

    def _shift(self, x, forward: bool):
        if self.shift_kind == "roll":
            return torch.roll(x, -self.roll_amount if forward else self.roll_amount, dims=1)
        if self.shift_kind == "perm":
            if forward:
                return permute_tokens(x, self.perm, self.inv_perm)
            return permute_tokens(x, self.inv_perm, self.perm)
        return x

    def forward(self, x, generator: Optional[torch.Generator] = None):
        B, N, C = x.shape
        if N != self.input_resolution:
            raise ValueError(f"block built for {self.input_resolution} tokens, got {N}")
        ws = self.window_size
        shortcut = x
        if not self.v2:
            x = self.norm1(x)
        x = self._shift(x, True).reshape(B, N // ws, ws, C)
        x = self.attn(x, self.win_groups, ln=self.norm1 if self.v2 else None,
                      generator=generator)
        x = self._shift(x.reshape(B, N, C), False)
        x = shortcut + self.drop_path(x, generator)
        if self.v2:
            return x + self.drop_path(self.norm2(self.mlp(x, generator)), generator)
        return x + self.drop_path(self.mlp(self.norm2(x), generator), generator)


class PatchMerging(nn.Module):
    """4 nested children -> parent: reshape (B, N/4, 4C) + LN + Linear(4C -> 2C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        B, N, C = x.shape
        return linear(self.norm(x.reshape(B, N // 4, 4 * C)), self.reduction)


class PatchExpand(nn.Module):
    """Parent -> 4 nested children: Linear(C -> 2C) + reshape (B, 4N, C/2) + LN."""

    def __init__(self, dim: int):
        super().__init__()
        self.expand = nn.Linear(dim, 2 * dim, bias=False)
        self.norm = LayerNorm(dim // 2)

    def forward(self, x):
        x = linear(x, self.expand)
        B, N, C = x.shape
        return self.norm(x.reshape(B, N * 4, C // 4))


class FinalPatchExpand_X4(nn.Module):
    """Token -> patch_size pixels: Linear(C -> p*C) + reshape (B, N*p, C) + LN."""

    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.expand = nn.Linear(dim, patch_size * dim, bias=False)
        self.norm = LayerNorm(dim)

    def forward(self, x):
        x = linear(x, self.expand)
        B, N, C = x.shape
        return self.norm(x.reshape(B, N * self.patch_size, C // self.patch_size))


class PatchEmbed(nn.Module):
    """Pixel sequence -> patch tokens: Conv1d(k = s = p) as reshape (B, N/p, p*f_in)
    + Linear; the weight keeps the Conv1d shape (embed, f_in, p)."""

    def __init__(self, patch_size: int, f_in: int, embed_dim: int, use_norm: bool):
        super().__init__()
        if patch_size % 4:
            raise ValueError("patch_size must be a multiple of 4 (valid nside in deeper layers)")
        self.patch_size = patch_size
        self.proj = nn.Conv1d(f_in, embed_dim, kernel_size=patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim) if use_norm else None

    def forward(self, x):
        B, N, Fi = x.shape
        p = self.patch_size
        w = self.proj.weight.permute(0, 2, 1).reshape(-1, p * Fi)  # (e, p*f_in)
        x = torch.nn.functional.linear(x.reshape(B, N // p, p * Fi), w.to(x.dtype),
                                       self.proj.bias.to(x.dtype))
        return x if self.norm is None else self.norm(x)


class BasicLayer(nn.Module):
    """Encoder stage: ``depth`` blocks (shift 0 / shift_size alternating) + optional
    PatchMerging."""

    def __init__(self, cfg, base_pix, dim, input_resolution, depth, num_heads, drop_path,
                 downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinHPBlock(cfg, dim, input_resolution, base_pix, num_heads,
                        0 if i % 2 == 0 else cfg.shift_size, drop_path[i])
            for i in range(depth)
        ])
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x, generator=None):
        for blk in self.blocks:
            x = blk(x, generator)
        return x if self.downsample is None else self.downsample(x)


class BasicLayerUp(nn.Module):
    """Decoder stage: ``depth`` blocks + optional PatchExpand."""

    def __init__(self, cfg, base_pix, dim, input_resolution, depth, num_heads, drop_path,
                 upsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinHPBlock(cfg, dim, input_resolution, base_pix, num_heads,
                        0 if i % 2 == 0 else cfg.shift_size, drop_path[i])
            for i in range(depth)
        ])
        self.upsample = PatchExpand(dim) if upsample else None

    def forward(self, x, generator=None):
        for blk in self.blocks:
            x = blk(x, generator)
        return x if self.upsample is None else self.upsample(x)


class UnetDecoder(nn.Module):
    """Mirror decoder: skip concat + concat_back_dim linears, ``norm_up``, then the
    tail FinalPatchExpand_X4 -> output (a Conv1d(k=1)-shaped weight, no bias)."""

    def __init__(self, cfg: SwinHPTransformerConfig, spec: DataSpec, dpr: List[float]):
        super().__init__()
        L = len(cfg.depths)
        num_patches = spec.dim_in // cfg.patch_size
        layers_up = []
        concat = [nn.Identity()]
        for inx in range(L):
            down_idx = L - 1 - inx
            concat_out = int(cfg.embed_dim * 2 ** down_idx)
            if inx == 0:
                layers_up.append(PatchExpand(concat_out))
                continue
            concat.append(nn.Linear(2 * concat_out, concat_out))
            layers_up.append(BasicLayerUp(
                cfg, spec.base_pix, concat_out, num_patches // (4 ** down_idx),
                cfg.depths[down_idx], cfg.num_heads[down_idx],
                dpr[sum(cfg.depths[:down_idx]):sum(cfg.depths[:down_idx + 1])],
                upsample=down_idx > 0))
        self.layers_up = nn.ModuleList(layers_up)
        self.concat_back_dim = nn.ModuleList(concat)
        self.norm_up = LayerNorm(cfg.embed_dim)
        self.up = FinalPatchExpand_X4(cfg.patch_size, cfg.embed_dim)
        self.output = nn.Conv1d(cfg.embed_dim, spec.f_out, kernel_size=1, bias=False)

    def forward(self, x, x_downsample, tail: bool = True, generator=None):
        L = len(self.layers_up)
        for inx, layer in enumerate(self.layers_up):
            if inx > 0:
                x = torch.cat([x, x_downsample[L - 1 - inx]], dim=-1)
                x = linear(x, self.concat_back_dim[inx])
                x = layer(x, generator)
            else:
                x = layer(x)
        x = self.norm_up(x)
        if not tail:
            return x
        x = self.up(x)
        return torch.nn.functional.linear(x, self.output.weight[:, :, 0].to(x.dtype))


class SwinHPTransformerSys(nn.Module):
    """HEAL-SWIN-UNet.  forward(x (B, npix, f_in), tail=True, generator=None) ->
    (B, npix, f_out) f32.  In training mode every dropout mask -- DropPath
    (drop_path_rate), ``pos_drop`` and the blocks' proj and MLP dropout (drop_rate),
    attention dropout (attn_drop_rate) -- is drawn from ``generator``, in the order the
    JAX model draws its own.

    Parameters are made on the CPU from ``generator`` (seeded 0 when not given) and
    then moved to ``device`` (the first CUDA device when None; raises without one), so
    a seed gives the same weights on every device; the global RNG is left as it
    was."""

    def __init__(self, config: SwinHPTransformerConfig, data_spec: DataSpec,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.use_checkpoint:
            raise NotImplementedError("use_checkpoint (activation recomputation) is not "
                                      "ported yet")
        device = default_device(device)
        cfg = config
        self.config = cfg
        self.data_spec = data_spec
        # the modules' default inits draw from the global RNG; they run on a fork of
        # it and are all overwritten by reset_parameters from ``generator``
        with torch.random.fork_rng(devices=[]):
            L = len(cfg.depths)
            num_patches = data_spec.dim_in // cfg.patch_size
            self.patch_embed = PatchEmbed(cfg.patch_size, data_spec.f_in, cfg.embed_dim,
                                          cfg.patch_embed_norm_layer is not None)
            if cfg.ape:
                self.absolute_pos_embed = nn.Parameter(torch.zeros(1, num_patches, cfg.embed_dim))
            self.pos_drop = Dropout(cfg.drop_rate)
            dpr = list(np.linspace(0, cfg.drop_path_rate, sum(cfg.depths)))
            self.layers = nn.ModuleList([
                BasicLayer(cfg, data_spec.base_pix, int(cfg.embed_dim * 2 ** i),
                           num_patches // (4 ** i), cfg.depths[i], cfg.num_heads[i],
                           dpr[sum(cfg.depths[:i]):sum(cfg.depths[:i + 1])],
                           downsample=i < L - 1)
                for i in range(L)
            ])
            self.norm = LayerNorm(int(cfg.embed_dim * 2 ** (L - 1)))
            self.decoder = UnetDecoder(cfg, data_spec, dpr)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init: trunc-normal(0.02) weights, zero biases, LN ones and
        zeros, logit scale ln 10, zero rel-pos tables.  The draws are made on the CPU
        from ``generator`` (a CPU generator) and copied in, so that a seed gives the
        same weights wherever the network lives."""

        def draw(w):
            w.copy_(trunc_normal_(torch.empty(w.shape, dtype=w.dtype), generator))

        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d)):
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
                    m.relative_position_bias_table.zero_()
        if self.config.ape:
            draw(self.absolute_pos_embed)

    def forward(self, x, tail: bool = True, generator: Optional[torch.Generator] = None):
        cfg = self.config
        x = self.patch_embed(x.to(cfg.compute_dtype))
        if cfg.ape:
            x = x + self.absolute_pos_embed.to(x.dtype)
        x = self.pos_drop(x, generator)
        x_downsample = []
        for layer in self.layers:
            x_downsample.append(x)
            x = layer(x, generator)
        x = self.decoder(self.norm(x), x_downsample, tail, generator)
        return x if not tail else x.float()
