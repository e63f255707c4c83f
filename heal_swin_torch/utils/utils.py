"""Misc utilities: python-module config loading, checkpoint resolution, paths (the
port's copy of ``heal_swin_tpu/utils/utils.py``, on the port's tracking store and
checkpoints).

Mirrors reference ``heal_swin/utils/utils.py``: configs are Python modules loaded by
path (``get_config_from_config_path``, reference :209-216) and checkpoints are resolved
from an MLflow run id or explicit path (``check_and_get_ckpt_paths``, reference
:141-198).
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import os
import uuid
from pathlib import Path
from typing import Optional


def get_config_from_config_path(config_path, function_name):
    """Load a Python config module by file path and call its config factory."""
    name = f"_heal_swin_config_{uuid.uuid4().hex[:8]}"
    loader = importlib.machinery.SourceFileLoader(name, str(config_path))
    spec = importlib.util.spec_from_loader(name, loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return getattr(module, function_name)()


def get_mlruns_path() -> Path:
    """Tracking root: $HEAL_SWIN_MLRUNS or ./mlruns."""
    return Path(os.environ.get("HEAL_SWIN_MLRUNS", "mlruns")).absolute()


def get_datasets_path() -> Path:
    """Dataset root: $HEAL_SWIN_DATA_ROOT or ./datasets."""
    return Path(os.environ.get("HEAL_SWIN_DATA_ROOT", "datasets")).absolute()


def load_config(run_id: str, config_name: str):
    """Load a saved config object from a run's artifacts (reference utils.load_config,
    utils.py:201-206)."""
    from heal_swin_torch.tracking.mlflow_store import MlflowFileStore
    from heal_swin_torch.utils import serialize

    store = MlflowFileStore(get_mlruns_path())
    return serialize.load(store.find_artifacts_dir(run_id) / config_name)


def check_and_get_ckpt_paths(path_or_run_id: str, epoch: Optional[str] = "best",
                             epoch_number: Optional[str] = None):
    """Resolve (ckpt_path, artifacts_dir, run_id|None) from an MLflow run id or an
    explicit checkpoint path (reference utils.py:141-198)."""
    from heal_swin_torch.tracking.mlflow_store import MlflowFileStore
    from heal_swin_torch.training.checkpoint import find_checkpoint

    p = Path(path_or_run_id)
    if p.exists() and p.suffix == ".ckpt":
        return p, p.parent.parent, None
    store = MlflowFileStore(get_mlruns_path())
    run = store.get_run(path_or_run_id)
    ckpt = find_checkpoint(run.artifact_dir, epoch=epoch, epoch_number=epoch_number)
    return ckpt, run.artifact_dir, path_or_run_id
