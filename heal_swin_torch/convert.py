"""JAX package parameters -> the port's ``state_dict``.

``state_dict_from_flax(params)`` takes the HEAL-SWIN-UNet parameter tree of
``heal_swin_tpu`` (``{"params": ...}`` or the inner dict; leaves as numpy arrays) and
returns the port's state_dict under the original torch HEAL-SWIN's key names:
flax ``layer0/block1/attn/qkv/kernel`` (in, out) becomes
``layers.0.blocks.1.attn.qkv.weight`` (out, in); LayerNorm ``ln/scale`` becomes
``.weight``; the patch embedding and the output head keep their Conv1d shapes
(embed, f_in, p) and (f_out, embed, 1).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _module_path(parts) -> str:
    out = []
    for p in parts:
        if p == "ln":  # the JAX LayerNorm wrapper level
            continue
        if p == "expand0":
            out.append("layers_up.0")
        elif p.startswith("layer_up"):
            out.append(f"layers_up.{p[len('layer_up'):]}")
        elif p.startswith("layer"):
            out.append(f"layers.{p[len('layer'):]}")
        elif p.startswith("block"):
            out.append(f"blocks.{p[len('block'):]}")
        elif p.startswith("concat_back_dim"):
            out.append(f"concat_back_dim.{p[len('concat_back_dim'):]}")
        else:
            out.append(p)
    return ".".join(out)


def _torch_key(path: str, value: np.ndarray, patch_size: int):
    """(state_dict key, tensor value) for one flax leaf path."""
    parts = path.split("/")
    leaf = parts[-1]
    body = _module_path(parts[:-1])
    if leaf == "kernel":
        if parts[:2] == ["patch_embed", "proj"]:  # Dense (p*f_in, e) -> Conv1d (e, f_in, p)
            e = value.shape[1]
            return ("patch_embed.proj.weight",
                    value.reshape(patch_size, -1, e).transpose(2, 1, 0))
        if parts[-2] == "output":  # Dense (e, f_out) -> Conv1d k=1 (f_out, e, 1)
            return body + ".weight", value.T[:, :, None]
        return body + ".weight", value.T
    if leaf == "bias":
        return body + ".bias", value
    if leaf == "scale":
        return body + ".weight", value
    if leaf in ("relative_position_bias_table", "logit_scale"):
        return f"{body}.{leaf}" if body else leaf, value
    if leaf == "absolute_pos_embed":
        return "absolute_pos_embed", value
    raise KeyError(f"no torch key for flax path {path!r}")


def state_dict_from_flax(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """The port's state_dict (float32 tensors) for a JAX HEAL-SWIN-UNet param tree."""
    tree = params["params"] if "params" in params else params
    flat = _flatten(tree)
    up = flat["decoder/up/expand/kernel"]  # (C, p*C)
    patch_size = up.shape[1] // up.shape[0]
    sd = OrderedDict()
    for path, value in flat.items():
        key, arr = _torch_key(path, value, patch_size)
        if key in sd:
            raise KeyError(f"two flax leaves map to {key!r}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return sd
