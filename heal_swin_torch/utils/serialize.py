"""Config persistence: pickle snapshots + flattened param dicts (the port's copy of
``heal_swin_tpu/utils/serialize.py``, with the standard library's ``pickle`` in place
of ``dill``).

Mirrors reference ``heal_swin/utils/serialize.py`` (save/load of config objects) and
the ``train.py:219-227`` hyperparameter normalization (nested dataclasses flattened
with dot-separated keys and ``train./model./data./data_spec.`` prefixes).  The config
dataclasses are module-level classes, which pickle takes; a lambda or a local class
in a config does not pickle, where dill would.
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path


def save(obj, path):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def to_plain(obj):
    """dataclass / nested structure -> plain dicts/lists/scalars."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_plain(v) for v in obj]
    if hasattr(obj, "__dict__") and not isinstance(obj, (str, bytes)):
        try:
            return {k: to_plain(v) for k, v in vars(obj).items()}
        except TypeError:
            return str(obj)
    return obj


def flatten(d, prefix=""):
    """Nested dict -> flat dict with dot-separated keys (pandas json_normalize style)."""
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out


def flatten_config(obj, prefix=""):
    plain = to_plain(obj)
    if not isinstance(plain, dict):
        return {prefix.rstrip("."): plain}
    return flatten(plain, prefix)
