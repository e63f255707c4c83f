"""JAX package parameters -> the port's ``state_dict``.

``state_dict_from_flax(params)`` takes the HEAL-SWIN-UNet parameter tree of
``heal_swin_tpu`` (``{"params": ...}`` or the inner dict; leaves as numpy arrays) and
returns the port's state_dict under the original torch HEAL-SWIN's key names:
flax ``layer0/block1/attn/qkv/kernel`` (in, out) becomes
``layers.0.blocks.1.attn.qkv.weight`` (out, in); LayerNorm ``ln/scale`` becomes
``.weight``; the patch embedding and the output head keep their Conv1d shapes
(embed, f_in, p) and (f_out, embed, 1).

The flat SWIN-UNet's tree (``heal_swin_tpu.models.swin_flat``) names its modules at the
top level (``patch_embed_proj``, ``layer{i}_block{j}``, ``downsample{i}``, ``norm``,
``expand0``, ``concat_back_dim{k}``, ``layer_up{k}_block{j}``, ``upsample{k}``,
``norm_up``, ``up``, ``output``); they take the original torch SWIN-UNet's keys
(``patch_embed.proj``, ``layers.{i}.blocks.{j}``, ``layers.{i}.downsample``,
``layers_up.0``, ``concat_back_dim.{k}``, ``layers_up.{k}.blocks.{j}``,
``layers_up.{k}.upsample``), and its patch embedding and head the Conv2d shapes
(embed, f_in, ph, pw) and (f_out, embed, 1, 1).

``adam_state_from_optax(opt_state, model, optimizer)`` carries the JAX trainer's Adam
state across the same way, so that a JAX run's checkpoint goes on in the port.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from functools import partial
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


_FLAT_TOP = (  # the flat model's top-level flax names -> the torch SWIN-UNet's
    (r"patch_embed_(proj|norm)", r"patch_embed.\1"),
    (r"layer(\d+)_block(\d+)", r"layers.\1.blocks.\2"),
    (r"downsample(\d+)", r"layers.\1.downsample"),
    (r"expand0", r"layers_up.0"),
    (r"layer_up(\d+)_block(\d+)", r"layers_up.\1.blocks.\2"),
    (r"upsample(\d+)", r"layers_up.\1.upsample"),
    (r"concat_back_dim(\d+)", r"concat_back_dim.\1"),
)


def _flat_module_path(parts) -> str:
    top = parts[0]
    for pattern, repl in _FLAT_TOP:
        if re.fullmatch(pattern, top):
            top = re.sub(pattern, repl, top)
            break
    return ".".join([top] + [p for p in parts[1:] if p != "ln"])


def _is_flat_tree(tree: Mapping) -> bool:
    """Whether a JAX parameter tree (inside ``params``) is the flat SWIN-UNet's."""
    return "patch_embed_proj" in tree


def _flat_torch_key(path: str, value: np.ndarray, patch_size):
    """(state_dict key, tensor value) for one leaf of the flat model's tree."""
    parts = path.split("/")
    leaf = parts[-1]
    body = _flat_module_path(parts[:-1]) if len(parts) > 1 else ""
    if leaf == "kernel":
        if parts[0] == "patch_embed_proj":  # (ph*pw*f_in, e) -> Conv2d (e, f_in, ph, pw)
            ph, pw = patch_size
            e = value.shape[1]
            return "patch_embed.proj.weight", value.reshape(ph, pw, -1, e).transpose(3, 2, 0, 1)
        if parts[0] == "output":  # (e, f_out) -> Conv2d k=1 (f_out, e, 1, 1)
            return "output.weight", value.T[:, :, None, None]
        return body + ".weight", value.T
    if leaf == "bias":
        return body + ".bias", value
    if leaf == "scale":
        return body + ".weight", value
    if leaf in ("relative_position_bias_table", "logit_scale", "absolute_pos_embed"):
        return f"{body}.{leaf}" if body else leaf, value
    raise KeyError(f"no torch key for flax path {path!r}")


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


def state_dict_from_flax(params: Mapping, patch_size=None) -> "OrderedDict[str, torch.Tensor]":
    """The port's state_dict (float32 tensors) for a JAX HEAL-SWIN-UNet or flat
    SWIN-UNet param tree.  ``patch_size``: the flat model's (ph, pw), which its tree
    does not hold (a square patch is taken when None); the HP model's comes from its
    tree."""
    tree = params["params"] if "params" in params else params
    flat = _flatten(tree)
    if _is_flat_tree(tree):
        if patch_size is None:
            up = flat["up/expand/kernel"]  # (C, p1*p2*C)
            side = int(round(np.sqrt(up.shape[1] // up.shape[0])))
            patch_size = (side, side)
        to_key = partial(_flat_torch_key, patch_size=tuple(patch_size))
    else:
        up = flat["decoder/up/expand/kernel"]  # (C, p*C)
        to_key = partial(_torch_key, patch_size=up.shape[1] // up.shape[0])
    sd = OrderedDict()
    for path, value in flat.items():
        key, arr = to_key(path, value)
        if key in sd:
            raise KeyError(f"two flax leaves map to {key!r}")
        sd[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return sd


def _as_tree(x):
    """An optax state (NamedTuples, tuples, dicts; or flax's state-dict form of them,
    nested dicts with the tuples' items under "0", "1", ...) as nested dicts."""
    if hasattr(x, "_asdict"):
        return {k: _as_tree(v) for k, v in x._asdict().items()}
    if isinstance(x, Mapping):
        return {str(k): _as_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return {str(i): _as_tree(v) for i, v in enumerate(x)}
    return x


def _find(tree, has):
    """The first node of ``tree`` (depth first) holding every key in ``has``."""
    if not isinstance(tree, Mapping):
        return None
    if all(k in tree for k in has):
        return tree
    for v in tree.values():
        hit = _find(v, has)
        if hit is not None:
            return hit
    return None


def adam_state_from_optax(opt_state, model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer) -> dict:
    """The ``state_dict`` of the port's Adam / AdamW ``optimizer`` (made over
    ``model.parameters()``) for the JAX trainer's optax state: ``inject_hyperparams``
    around a chain holding ``scale_by_adam``'s ``ScaleByAdamState`` (count, mu, nu),
    as optax objects or in flax's state-dict form, leaves as numpy arrays (of an
    ``optax.MultiSteps`` state its inner Adam state, without the accumulated gradients;
    pass a ``MultiSteps``' ``inner`` optimizer).  ``mu`` and ``nu`` take the
    parameters' key and transpose rules (``state_dict_from_flax``, with a flat model's
    patch size from its config), each parameter's
    ``step`` is the count, and every param group's learning rate the injected one."""
    tree = _as_tree(opt_state)
    adam = _find(tree, ("count", "mu", "nu"))
    hyper = _find(tree, ("hyperparams",))
    if adam is None or hyper is None:
        raise KeyError("no inject_hyperparams / ScaleByAdamState in the optax state")
    patch = getattr(getattr(model, "config", None), "patch_size", None)
    patch = patch if isinstance(patch, tuple) else None  # the flat model's (ph, pw)
    mu, nu = state_dict_from_flax(adam["mu"], patch), state_dict_from_flax(adam["nu"], patch)
    step = float(np.asarray(adam["count"]))
    index = {id(p): i for i, p in
             enumerate(p for g in optimizer.param_groups for p in g["params"])}
    state = {}
    for name, prm in model.named_parameters():
        state[index[id(prm)]] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu[name].to(prm.device, prm.dtype),
            "exp_avg_sq": nu[name].to(prm.device, prm.dtype),
        }
    lr = float(np.asarray(hyper["hyperparams"]["learning_rate"]))
    sd = optimizer.state_dict()
    return {"state": state, "param_groups": [dict(g, lr=lr) for g in sd["param_groups"]]}
