"""The flat (2-D) SWIN-UNet baseline in PyTorch (counterpart of
``heal_swin_tpu/models/swin_flat.py``; reference ``heal_swin/models_torch/
swin_transformer.py``, adapted there from HuCaoFighting/Swin-Unet).

Channels-last (B, H, W, C) images; the blocks work on (B, H*W, C) tokens.  Windows are
a reshape and transpose of the (B, H, W, C) grid, shifted windows a ``torch.roll`` by
(-sh, -sw) on the two grid axes with the 9-region SWIN mask as (nW, wh*ww) int32 group
ids, and the relative position bias a (2wh-1)(2ww-1)-entry table, trunc-normal
initialised.  Attention runs through ``layers.WindowAttention``'s routes: at window 8 x
8 and head dim 32 the cosine blocks at C <= 384 run K1 (backward K4), the C = 768
blocks K2 (backward K5), and active attention dropout the plain route.  The SWIN-v2
res-post-norm follows the inverse shift, outside the attention, as in the JAX model.

The reference rolls both axes by ``shift[0]`` (swin_transformer.py:365-368, a FIXME
there); this model, like the JAX one, rolls by (shift[0], shift[1]).  All shipped
configs shift symmetrically, where both agree.

Inputs (B, H, W, f_in); outputs (B, H, W, f_out) float32, or with ``tail=False`` the
(B, Hp*Wp, C) patch tokens after ``norm_up`` in the compute dtype.  A training forward
takes an explicit ``torch.Generator`` for its dropout masks, as the HEAL-SWIN model's.
Parameter names follow the original torch SWIN-UNet (``layers.{i}.blocks.{j}``,
``layers.{i}.downsample``, ``layers_up.{k}``, ``concat_back_dim.{k}``, ``norm_up``,
``up``, ``output``); the patch embedding and the head keep their Conv2d shapes.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

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
    reset_parameters,
)
from heal_swin_torch.ops._dispatch import default_device


@dataclass
class SwinTransformerConfig:
    """The fields and defaults of ``heal_swin_tpu.models.swin_flat.SwinTransformerConfig``
    (reference SwinTransformerConfig, swin_transformer.py:796-820), so one config drives
    both packages.  ``dtype``, ``attention_impl`` and ``fused_final_head`` as in
    ``swin_hp.SwinHPTransformerConfig``."""

    patch_size: Union[int, Tuple[int, int]] = (4, 4)
    window_size: Union[int, Tuple[int, int]] = (4, 4)
    shift_size: Union[int, Tuple[int, int]] = -1  # -1 -> window // 2
    embed_dim: int = 96
    patch_embed_norm_layer: Optional[str] = None
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
    final_upsample: str = "expand_first"
    use_masking: bool = True
    use_rel_pos_bias: bool = True
    dev_mode: bool = False
    dtype: Optional[str] = None
    gelu_approx: bool = False
    attention_impl: str = "auto"
    fused_final_head: bool = True

    @property
    def compute_dtype(self) -> torch.dtype:
        return {None: torch.float32, "float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.dtype]

    def normalized(self) -> "SwinTransformerConfig":
        """int -> pair, shift -1 -> window // 2 (reference swin_transformer.py:862-921)."""

        def pair(v):
            if isinstance(v, int):
                return (v, v)
            v = tuple(v)
            return (v[0], v[0]) if len(v) == 1 else v

        ps, ws = pair(self.patch_size), pair(self.window_size)
        ss = (ws[0] // 2, ws[1] // 2) if self.shift_size == -1 else pair(self.shift_size)
        return dataclasses.replace(self, patch_size=ps, window_size=ws, shift_size=ss)


@functools.lru_cache(maxsize=None)
def rel_pos_index_2d(wh: int, ww: int) -> np.ndarray:
    """(wh*ww, wh*ww) index into the (2wh-1)(2ww-1) relative-position table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def shift_win_groups(H: int, W: int, wh: int, ww: int, sh: int, sw: int) -> np.ndarray:
    """The 9-region SWIN shift mask as (nW, wh*ww) int32 group ids (reference
    swin_transformer.py:312-352)."""
    img = np.zeros((H, W), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -sh), slice(-sh, None)):
        for ws_ in (slice(0, -ww), slice(-ww, -sw), slice(-sw, None)):
            img[hs, ws_] = cnt
            cnt += 1
    return img.reshape(H // wh, wh, W // ww, ww).transpose(0, 2, 1, 3).reshape(-1, wh * ww)


def window_partition(x, wh, ww):
    """(B, H, W, C) -> (B, nW, wh*ww, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // wh, wh, W // ww, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // wh) * (W // ww), wh * ww, C)


def window_reverse(x, wh, ww, H, W):
    """(B, nW, wh*ww, C) -> (B, H, W, C)."""
    B, C = x.shape[0], x.shape[-1]
    x = x.reshape(B, H // wh, W // ww, wh, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


class SwinBlock2D(nn.Module):
    """One SWIN block on the (H, W) token grid (reference SwinTransformerBlock,
    swin_transformer.py:219-441).  A stage no larger than its window in either axis
    takes the whole stage as its one window, unshifted."""

    def __init__(self, cfg: SwinTransformerConfig, dim: int, input_resolution, num_heads: int,
                 shift_size, drop_path: float):
        super().__init__()
        H, W = input_resolution
        wh, ww = cfg.window_size
        sh, sw = shift_size
        if H <= wh or W <= ww:
            wh, ww, sh, sw = H, W, 0, 0
        if not (0 <= sh < wh and 0 <= sw < ww):
            raise ValueError(f"shift {(sh, sw)} outside the window {(wh, ww)}")
        self.input_resolution = (H, W)
        self.window = (wh, ww)
        self.shift = (sh, sw)
        self.v2 = cfg.use_v2_norm_placement
        shifted = sh > 0 or sw > 0
        groups = None
        if cfg.use_masking and shifted:
            groups = torch.tensor(shift_win_groups(H, W, wh, ww, sh, sw), dtype=torch.int32)
        self.register_buffer("win_groups", groups, persistent=False)
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(
            dim, num_heads, qkv_bias=cfg.qkv_bias, qk_scale=cfg.qk_scale,
            attn_drop=cfg.attn_drop_rate, proj_drop=cfg.drop_rate,
            use_cos_attn=cfg.use_cos_attn,
            rel_pos_index=rel_pos_index_2d(wh, ww) if cfg.use_rel_pos_bias else None,
            rel_pos_table_size=(2 * wh - 1) * (2 * ww - 1), rel_pos_init_zero=False,
            attention_impl=cfg.attention_impl)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio), dim, drop=cfg.drop_rate,
                       gelu_approx=cfg.gelu_approx)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        H, W = self.input_resolution
        B, L, C = x.shape
        if L != H * W:
            raise ValueError(f"block built for {H} x {W} tokens, got {L}")
        (wh, ww), (sh, sw) = self.window, self.shift
        shortcut = x
        if not self.v2:
            x = self.norm1(x)
        x = x.reshape(B, H, W, C)
        if sh or sw:
            x = torch.roll(x, (-sh, -sw), dims=(1, 2))
        x = self.attn(window_partition(x, wh, ww), self.win_groups, generator=generator)
        x = window_reverse(x, wh, ww, H, W)
        if sh or sw:
            x = torch.roll(x, (sh, sw), dims=(1, 2))
        x = x.reshape(B, L, C)
        if self.v2:
            x = shortcut + self.drop_path(self.norm1(x), generator)
            return x + self.drop_path(self.norm2(self.mlp(x, generator)), generator)
        x = shortcut + self.drop_path(x, generator)
        return x + self.drop_path(self.mlp(self.norm2(x), generator), generator)


class PatchMerging2D(nn.Module):
    """2x2 space-to-depth in the order (0,0), (1,0), (0,1), (1,1) of (h, w) offsets, LN,
    Linear(4C -> 2C) (reference swin_transformer.py:426-464)."""

    def __init__(self, input_resolution, dim: int):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        H, W = self.input_resolution
        B, L, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
        return linear(self.norm(x.reshape(B, (H // 2) * (W // 2), 4 * C)), self.reduction)


def depth_to_space(x, H, W, p1, p2):
    """(B, H*W, p1*p2*c) -> (B, (H*p1)*(W*p2), c): token (h, w)'s column slice
    d1*p2 + d2 lands on pixel (h*p1 + d1, w*p2 + d2)."""
    B, _, C = x.shape
    c = C // (p1 * p2)
    x = x.reshape(B, H, W, p1, p2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H * p1 * W * p2, c)


class PatchExpand2D(nn.Module):
    """Linear(C -> 2C), depth-to-space 2 x 2, LN (reference swin_transformer.py:477-501)."""

    def __init__(self, input_resolution, dim: int):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.expand = nn.Linear(dim, 2 * dim, bias=False)
        self.norm = LayerNorm(dim // 2)

    def forward(self, x):
        H, W = self.input_resolution
        return self.norm(depth_to_space(linear(x, self.expand), H, W, 2, 2))


class FinalPatchExpand2D(nn.Module):
    """Linear(C -> p1*p2*C), depth-to-space (p1, p2), LN (reference
    swin_transformer.py:504-535)."""

    def __init__(self, input_resolution, patch_size, dim: int):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.patch_size = tuple(patch_size)
        self.expand = nn.Linear(dim, patch_size[0] * patch_size[1] * dim, bias=False)
        self.norm = LayerNorm(dim)

    def forward(self, x):
        H, W = self.input_resolution
        return self.norm(depth_to_space(linear(x, self.expand), H, W, *self.patch_size))


class PatchEmbed2D(nn.Module):
    """Conv2d(k = s = patch) as space-to-depth in (ph, pw, f_in) order and a Linear; the
    weight keeps the Conv2d shape (embed, f_in, ph, pw)."""

    def __init__(self, patch_size, f_in: int, embed_dim: int, use_norm: bool):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = nn.Conv2d(f_in, embed_dim, kernel_size=self.patch_size,
                              stride=self.patch_size)
        self.norm = LayerNorm(embed_dim) if use_norm else None

    def forward(self, x):
        B, H, W, Fi = x.shape
        ph, pw = self.patch_size
        x = x.reshape(B, H // ph, ph, W // pw, pw, Fi).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, (H // ph) * (W // pw), ph * pw * Fi)
        w = self.proj.weight.permute(0, 2, 3, 1).reshape(-1, ph * pw * Fi)  # (e, ph*pw*f_in)
        x = torch.nn.functional.linear(x, w.to(x.dtype), self.proj.bias.to(x.dtype))
        return x if self.norm is None else self.norm(x)


class BasicLayer2D(nn.Module):
    """A stage: ``depth`` blocks (shift 0 / shift_size alternating), then an optional
    PatchMerging2D (encoder) or PatchExpand2D (decoder)."""

    def __init__(self, cfg, dim, res, depth, num_heads, drop_path, downsample=False,
                 upsample=False):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock2D(cfg, dim, res, num_heads, (0, 0) if i % 2 == 0 else cfg.shift_size,
                        drop_path[i])
            for i in range(depth)
        ])
        self.downsample = PatchMerging2D(res, dim) if downsample else None
        self.upsample = PatchExpand2D(res, dim) if upsample else None

    def forward(self, x, generator=None):
        for blk in self.blocks:
            x = blk(x, generator)
        if self.downsample is not None:
            return self.downsample(x)
        return x if self.upsample is None else self.upsample(x)


class SwinTransformerSys(nn.Module):
    """Flat SWIN-UNet.  forward(x (B, H, W, f_in), tail=True, generator=None) -> (B, H,
    W, f_out) float32; the dropout masks in training as in ``SwinHPTransformerSys``.

    Parameters are made on the CPU from ``generator`` (seeded 0 when not given) and
    moved to ``device`` (the first CUDA device when None; raises without one)."""

    def __init__(self, config: SwinTransformerConfig, data_spec: DataSpec, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.use_checkpoint:
            raise NotImplementedError("use_checkpoint (activation recomputation) is not "
                                      "ported yet")
        if config.final_upsample != "expand_first":
            raise ValueError(f"final_upsample {config.final_upsample!r}: only "
                             "'expand_first' builds an output head")
        device = default_device(device)
        cfg = config.normalized()
        self.config = cfg
        self.data_spec = data_spec
        H, W = data_spec.dim_in
        L = len(cfg.depths)
        merge = 2 ** (L - 1)
        (ph, pw), (wh, ww) = cfg.patch_size, cfg.window_size
        for name, n, k in (("H", H, merge * ph * wh), ("W", W, merge * pw * ww)):
            if n % k:
                raise ValueError(f"{name} must be divisible by merge_factor*patch*window, "
                                 f"got {name}={n}, {k}")
        pr = (H // ph, W // pw)
        with torch.random.fork_rng(devices=[]):
            self.patch_embed = PatchEmbed2D(cfg.patch_size, data_spec.f_in, cfg.embed_dim,
                                            cfg.patch_embed_norm_layer is not None)
            if cfg.ape:
                self.absolute_pos_embed = nn.Parameter(torch.zeros(1, pr[0] * pr[1],
                                                                   cfg.embed_dim))
            self.pos_drop = Dropout(cfg.drop_rate)
            dpr = list(np.linspace(0, cfg.drop_path_rate, sum(cfg.depths)))

            def stage(i, **kw):
                return BasicLayer2D(cfg, int(cfg.embed_dim * 2 ** i),
                                    (pr[0] // 2 ** i, pr[1] // 2 ** i), cfg.depths[i],
                                    cfg.num_heads[i],
                                    dpr[sum(cfg.depths[:i]):sum(cfg.depths[:i + 1])], **kw)

            self.layers = nn.ModuleList([stage(i, downsample=i < L - 1) for i in range(L)])
            self.norm = LayerNorm(int(cfg.embed_dim * 2 ** (L - 1)))
            up = [PatchExpand2D((pr[0] // merge, pr[1] // merge),
                                int(cfg.embed_dim * 2 ** (L - 1)))]
            concat = [nn.Identity()]
            for inx in range(1, L):
                d = L - 1 - inx
                dim = int(cfg.embed_dim * 2 ** d)
                concat.append(nn.Linear(2 * dim, dim))
                up.append(stage(d, upsample=d > 0))
            self.layers_up = nn.ModuleList(up)
            self.concat_back_dim = nn.ModuleList(concat)
            self.norm_up = LayerNorm(cfg.embed_dim)
            self.up = FinalPatchExpand2D(pr, cfg.patch_size, cfg.embed_dim)
            self.output = nn.Conv2d(cfg.embed_dim, data_spec.f_out, kernel_size=1, bias=False)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))
        self.to(device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init (``layers.reset_parameters``; trunc-normal rel-pos
        tables)."""
        reset_parameters(self, generator, self.absolute_pos_embed if self.config.ape else None)

    def head_weight(self) -> torch.Tensor:
        """The output head as a (f_out, C) matrix."""
        return self.output.weight[:, :, 0, 0]

    def forward(self, x, tail: bool = True, generator: Optional[torch.Generator] = None):
        cfg = self.config
        H, W = self.data_spec.dim_in
        B = x.shape[0]
        if tuple(x.shape[1:3]) != (H, W):
            raise ValueError(f"input image size {tuple(x.shape[1:3])} doesn't match the "
                             f"model ({H}, {W})")
        x = self.patch_embed(x.to(cfg.compute_dtype))
        if cfg.ape:
            x = x + self.absolute_pos_embed.to(x.dtype)
        x = self.pos_drop(x, generator)
        x_downsample = []
        for layer in self.layers:
            x_downsample.append(x)
            x = layer(x, generator)
        x = self.norm(x)
        L = len(self.layers_up)
        for inx, layer in enumerate(self.layers_up):
            if inx == 0:
                x = layer(x)
                continue
            x = torch.cat([x, x_downsample[L - 1 - inx]], dim=-1)
            x = layer(linear(x, self.concat_back_dim[inx]), generator)
        x = self.norm_up(x)
        if not tail:
            return x
        x = torch.nn.functional.linear(self.up(x), self.head_weight().to(x.dtype))
        return x.reshape(B, H, W, -1).float()
