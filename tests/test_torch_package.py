"""heal_swin_torch as a package of its own: it imports nothing of the JAX package, its
copies of the JAX package's host modules give the same shift permutations at the
paper's size, and its entry points run on the GPU unless asked for the CPU."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import heal_swin_torch
from heal_swin_torch.ops import shifting as tsh
from heal_swin_tpu.ops import shifting as jsh

REPO = Path(__file__).resolve().parents[1]


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(heal_swin_torch.__path__,
                                                         "heal_swin_torch."))


def test_port_and_chip_smoke_import_without_the_jax_package():
    """Every module of the port, and chip_smoke.py, imports with jax, flax, optax, dill,
    msgpack and heal_swin_tpu blocked."""
    mods = _port_modules()
    assert {"heal_swin_torch.ops.chamfer_pruned", "heal_swin_torch.ops.mlp",
            "heal_swin_torch.run_configs", "heal_swin_torch.training.trainer",
            "heal_swin_torch.training.checkpoint", "heal_swin_torch.training.train_config",
            "heal_swin_torch.tracking", "heal_swin_torch.tracking.mlflow_store",
            "heal_swin_torch.tracking.client", "heal_swin_torch.tracking.server",
            "heal_swin_torch.data.loading", "heal_swin_torch.data.synthetic",
            "heal_swin_torch.data.data", "heal_swin_torch.utils.serialize",
            "heal_swin_torch.utils.utils"} <= set(mods)
    assert len(mods) >= 38
    blocked = ("jax", "flax", "heal_swin_tpu", "optax", "dill", "msgpack")
    code = ("import sys\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            f"import importlib\nfor m in {mods + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            f"assert not any(k.split('.')[0] in {blocked!r} and v is not None\n"
            "               for k, v in sys.modules.items())\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("tokens", [131072, 32768, 8192, 2048])
def test_ring_shift_matches_jax_at_paper_size(tokens):
    """The paper model's ring_shift at nside 256 (patch 4): each stage's token count,
    window 64, shift 4.  The JAX package builds them through its C++ HEALPix core,
    the port through its numpy copy."""
    want = jsh.get_shift_spec("ring_shift", tokens, 8, 64, 4)
    got = tsh.get_shift_spec("ring_shift", tokens, 8, 64, 4)
    assert got.kind == want.kind == "perm"
    for name in ("perm", "inv_perm", "win_groups"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def test_entry_points_default_to_the_gpu():
    """With no device given, the tasks, the model, the metric states, the Chamfer
    entry points, the Chamfer writer and the Trainer take the first CUDA device, and
    raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("checks the machine without a CUDA device")
    from heal_swin_torch.data.data_spec import DataSpec, DepthDataSpec
    from heal_swin_torch.evaluation import hp_depth_pred_writers as W
    from heal_swin_torch.evaluation import metrics as M
    from heal_swin_torch.models import swin_hp, tasks
    from heal_swin_torch.ops import chamfer, chamfer_pruned
    from heal_swin_torch.training.train_config import PLConfig
    from heal_swin_torch.training.trainer import Trainer

    cfg = swin_hp.SwinHPTransformerConfig(embed_dim=8, depths=[2, 1], num_heads=[2, 2],
                                          window_size=16, shift_size=8)
    spec = DataSpec(dim_in=512, f_in=3, f_out=5)
    pts = np.ones((4, 3), np.float32)
    for make in (
        lambda: swin_hp.SwinHPTransformerSys(cfg, spec),
        lambda: tasks.WoodscapeSegmenterSwinHP(tasks.WoodscapeSegmenterSwinHPConfig(cfg), spec),
        lambda: tasks.WoodscapeDepthSwinHP(tasks.WoodscapeDepthSwinHPConfig(cfg),
                                           DepthDataSpec(dim_in=512, f_in=3, f_out=1)),
        lambda: M.seg_state_init(5),
        M.depth_state_init,
        lambda: chamfer.chamfer_distance(pts, pts),
        lambda: chamfer_pruned.chamfer_distance_pruned(pts, pts),
        W.WoodscapeHPDepthChamferDistBestWorstPredictionWriter,
        lambda: Trainer(PLConfig()),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    task = tasks.WoodscapeSegmenterSwinHP(tasks.WoodscapeSegmenterSwinHPConfig(cfg), spec,
                                          device="cpu")
    assert next(task.model.parameters()).device.type == "cpu"
    assert task.metric_init()["confmat"].device.type == "cpu"
    assert Trainer(PLConfig(), device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("T,C,dqkv,part", [(262144, 96, 452984832, 51523584),
                                           (65536, 192, 226492416, 25761792),
                                           (16384, 384, 113246208, 12880896)])
def test_chip_smoke_pins_the_qkv_backward_workspace(T, C, dqkv, part):
    """K17's workspace bytes a launch at the three stage shapes, as chip_smoke.py logs
    them: dqkv written once and read twice, and one partial row per run of 8 windows
    written and read once, an eighth of one row per window."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    assert chip_smoke.qkv_bwd_workspace(T, C) == (dqkv, part)
    assert chip_smoke.workspace_bytes(("window_attention_qkv_bwd", T, C, True)) == dqkv + part
    assert 8 * part == chip_smoke.qkv_bwd_workspace(T, C, run=1)[1]
