"""The port's run entry (``heal_swin_torch/train.py``, ``resume.py``) and
``Trainer.lr_find`` against the JAX package's on the CPU, on a 96 x 80 WoodScape fixture
projected on the device (``project_on_device=True``) at nside 16, with the test config's
network (``run_configs/swin_hp_test_run_config.py``: embed 4, window 16, depths [2, 1])
and the drop rates at 0 (the frameworks' dropout draws differ).

- ``train_model`` from a config file against the JAX ``train_model`` on the same fixture
  and the same initial weights (``TrainConfig.load_checkpoint``: a JAX checkpoint, and the
  port's of the same weights through ``convert.state_dict_from_flax``): 2 epochs x 2
  batches with sanity and epoch validation; every logged metric within ``FIT_TOL``
  (``tests/test_torch_trainer.py``'s), the ``This run has id`` line, the config artifacts,
  the hyperparameter keys (but the JAX entry's ``model_flops``) and the parameter counts.
- ``resume`` continues the port's run from its last.ckpt for one more epoch; ``python3 -m
  heal_swin_torch.cli train`` and ``resume`` run the config file on the CPU in a
  subprocess.
- ``lr_find`` against the JAX one from the same weights: the same learning rates
  (``LR_TOL``), the smoothed losses within ``LOSS_TOL`` relative, the same suggestion.
- ``eval_after_train=True`` evaluates the run after the fit; more than one GPU raises
  before any file is written; ``auto_lr_find`` logs its suggestion and fits at it.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heal_swin_torch.train as ttrain
from heal_swin_torch import resume as tresume
from heal_swin_torch.convert import state_dict_from_flax
from heal_swin_torch.data.data import get_data_module as t_get_data_module
from heal_swin_torch.data.synthetic_woodscape import generate
from heal_swin_torch.tracking.mlflow_store import MlflowFileStore as TStore
from heal_swin_torch.training import checkpoint as tckpt
from heal_swin_torch.training import train_config as ttc
from heal_swin_torch.training.trainer import Trainer as TTrainer
from heal_swin_torch.utils.utils import get_config_from_config_path
from heal_swin_tpu import train as jtrain
from heal_swin_tpu.data import data_config as jdc
from heal_swin_tpu.data.data import get_data_module as j_get_data_module
from heal_swin_tpu.models.swin_hp import SwinHPTransformerConfig
from heal_swin_tpu.models.tasks import MODEL_FROM_CONFIG_NAME, WoodscapeSegmenterSwinHPConfig
from heal_swin_tpu.tracking.mlflow_store import MlflowFileStore as JStore
from heal_swin_tpu.training import checkpoint as jckpt
from heal_swin_tpu.training.optimizer import OptimizerConfig
from heal_swin_tpu.training.train_config import PLConfig as JPLConfig
from heal_swin_tpu.training.train_config import SingleModelTrainRun, TrainConfig
from heal_swin_tpu.training.trainer import Trainer as JTrainer
from tests.test_torch_trainer import FIT_TOL, close_histories, history, to_port

NSIDE = 16
PL = dict(max_epochs=2, limit_train_batches=2, limit_val_batches=2, num_sanity_val_steps=1,
          log_every_n_steps=1, gpus=1)
CLOCK = ("train_time_per_sample in ms",)
LR_STEPS = 12
LR_TOL = dict(rtol=1e-12, atol=0)  # the rates: the same float64 formula
LOSS_TOL = dict(rtol=1e-6, atol=0)  # the smoothed losses of 12 f32 Adam steps (7e-9 seen)
ARTIFACTS = {"train_config", "pl_config", "model_config", "data_spec", "data_config",
             "run_config", "checkpoints"}
# a port run config file: the JAX run config of ``run_config()``, written with the
# port's classes (load_checkpoint and the data root come from the environment)
CONFIG_FILE = '''import os

from heal_swin_torch.data.data_config import WoodscapeCommonConfig, WoodscapeHPConfig
from heal_swin_torch.models.swin_hp import SwinHPTransformerConfig
from heal_swin_torch.models.tasks import WoodscapeSegmenterSwinHPConfig
from heal_swin_torch.training.optimizer import OptimizerConfig
from heal_swin_torch.training.train_config import PLConfig, SingleModelTrainRun, TrainConfig


def get_train_run_config():
    return SingleModelTrainRun(
        train=TrainConfig(mlflow_expmt="entry", job_id="entry_test", seed=42,
                          eval_after_train=False,
                          load_checkpoint=os.environ.get("ENTRY_TEST_WEIGHTS")),
        data=WoodscapeHPConfig(
            common=WoodscapeCommonConfig(version="woodscape", batch_size=2, val_batch_size=2,
                                         pred_batch_size=2, pred_samples=4, train_share=0.75),
            input_nside={nside}, input_base_pix=8, project_on_device=True),
        model=WoodscapeSegmenterSwinHPConfig(
            swin_hp_transformer_config=SwinHPTransformerConfig(
                patch_size=4, window_size=16, shift_size=8, shift_strategy="ring_shift",
                embed_dim=4, depths=[2, 1], num_heads=[2, 2], drop_rate=0.0,
                attn_drop_rate=0.0, drop_path_rate=0.0),
            optimizer_config=OptimizerConfig(learning_rate=1e-3)))


def get_resume_run_config():
    from heal_swin_torch.training.train_config import ResumeConfig

    return ResumeConfig(path=os.environ["RUN_ID"], epoch="last",
                        train_run_config=get_train_run_config())


def get_pl_config():
    return PLConfig(**dict({pl!r}, max_epochs=int(os.environ.get("ENTRY_TEST_EPOCHS", 2))))
'''.format(nside=NSIDE, pl=PL)


def run_config(load_checkpoint=None, **train):
    """The JAX run config of CONFIG_FILE."""
    return SingleModelTrainRun(
        train=TrainConfig(mlflow_expmt="entry", job_id="entry_test", seed=42,
                          eval_after_train=False, load_checkpoint=load_checkpoint, **train),
        data=jdc.WoodscapeHPConfig(
            common=jdc.WoodscapeCommonConfig(version="woodscape", batch_size=2, val_batch_size=2,
                                             pred_batch_size=2, pred_samples=4,
                                             train_share=0.75),
            input_nside=NSIDE, input_base_pix=8, project_on_device=True),
        model=WoodscapeSegmenterSwinHPConfig(
            swin_hp_transformer_config=SwinHPTransformerConfig(
                patch_size=4, window_size=16, shift_size=8, shift_strategy="ring_shift",
                embed_dim=4, depths=[2, 1], num_heads=[2, 2], drop_rate=0.0,
                attn_drop_rate=0.0, drop_path_rate=0.0),
            optimizer_config=OptimizerConfig(learning_rate=1e-3)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The fixture, the config file, and one set of initial weights as a JAX
    checkpoint and a port checkpoint: (root, config path, jax ckpt, port ckpt, params)."""
    root = tmp_path_factory.mktemp("entry")
    generate(root / "data", version="woodscape", n_per_cam=3, W=96, H=80, seed=0)
    cfg = root / "entry_config.py"
    cfg.write_text(CONFIG_FILE)
    mp = pytest.MonkeyPatch()
    mp.setenv("HEAL_SWIN_DATA_ROOT", str(root / "data"))
    rc = run_config()
    dm, spec = j_get_data_module(rc.data)
    task = MODEL_FROM_CONFIG_NAME[type(rc.model).__name__](rc.model, spec, rc.data)
    params = task.init_variables(jax.random.PRNGKey(3),
                                 jnp.zeros((1, spec.dim_in, 3), jnp.float32))
    rng = np.random.default_rng(5)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape)
                          .astype(np.float32), params)
    jpath, tpath = root / "init_jax.ckpt", root / "init_port.ckpt"
    jckpt.save_checkpoint(jpath, params, {}, {})
    tckpt.save_checkpoint(tpath, state_dict_from_flax(params), {}, {})
    mp.undo()
    return root, cfg, jpath, tpath, params


@pytest.fixture
def paths(world, tmp_path, monkeypatch):
    root = world[0]
    monkeypatch.setenv("HEAL_SWIN_DATA_ROOT", str(root / "data"))
    monkeypatch.setenv("HEAL_SWIN_MLRUNS", str(tmp_path / "mlruns"))
    return tmp_path


def run_params(run):
    return {p.name for p in (run.run_dir / "params").iterdir()}


def param_value(run, name):
    return (run.run_dir / "params" / name).read_text()


def test_train_model_matches_jax(world, paths, capsys, monkeypatch):
    root, cfg, jpath, tpath, _ = world
    monkeypatch.setenv("ENTRY_TEST_WEIGHTS", str(tpath))
    run_id, result = ttrain.train_model(
        get_config_from_config_path(cfg, "get_train_run_config"),
        get_config_from_config_path(cfg, "get_pl_config"), config_path=cfg, device="cpu")
    out = capsys.readouterr().out
    assert re.findall(r"This run has id (\w+)", out) == [run_id]
    jrun_id, _ = jtrain.train_model(run_config(str(jpath)), JPLConfig(**PL),
                                    store=JStore(paths / "jmlruns"))
    assert re.findall(r"This run has id (\w+)", capsys.readouterr().out) == [jrun_id]
    run, jrun = TStore(paths / "mlruns").get_run(run_id), JStore(paths / "jmlruns").get_run(jrun_id)
    assert run.status == jrun.status == "FINISHED"
    assert result.global_step == 4 and result.epochs_run == 2
    close_histories(history(run), history(jrun), FIT_TOL, skip=CLOCK)
    assert {p.name for p in run.artifact_dir.iterdir()} == ARTIFACTS | {cfg.name}
    assert {p.name for p in jrun.artifact_dir.iterdir()} == ARTIFACTS
    assert run_params(run) == run_params(jrun) - {"model_flops"}
    for name in run_params(run):
        if name.startswith(("total_params", "data_spec.", "batch_size", "effective",
                            "n_devices")):
            assert param_value(run, name) == param_value(jrun, name), name
    assert run.get_metric_history("epoch")[-1][1] == 1
    saved = get_config_from_config_path(cfg, "get_train_run_config")
    from heal_swin_torch.utils import serialize

    assert serialize.load(run.artifact_dir / "run_config") == saved


def test_resume_continues_the_run(world, paths, capsys, monkeypatch):
    root, cfg, _, tpath, _ = world
    monkeypatch.setenv("ENTRY_TEST_WEIGHTS", str(tpath))
    rc = get_config_from_config_path(cfg, "get_train_run_config")
    run_id, first = ttrain.train_model(rc, ttc.PLConfig(**dict(PL, max_epochs=1)),
                                       config_path=cfg, device="cpu")
    new_id, result = tresume.main(cfg, ttc.PLConfig(**PL), ttc.ResumeConfig(
        path=run_id, epoch="last", train_run_config=rc), device="cpu")
    assert new_id != run_id and first.global_step == 2 and result.global_step == 4
    store = TStore(paths / "mlruns")
    run, new = store.get_run(run_id), store.get_run(new_id)
    assert [v for _, v, _ in new.get_metric_history("epoch")] == [1]
    assert [s for _, _, s in new.get_metric_history("train_loss_step")] == [3, 4]
    assert (run.artifact_dir / cfg.name).exists()  # the resume config, in the first run
    _, _, meta = tckpt.load_checkpoint(new.artifact_dir / "checkpoints" / "last.ckpt")
    assert meta["epoch"] == 1 and meta["global_step"] == 4


def test_lr_find_matches_jax(world, paths, monkeypatch):
    root, cfg, _, _, params = world
    rc = run_config()
    kw = dict(min_lr=1e-6, max_lr=1e-1, num_training=LR_STEPS)
    jdm, jspec = j_get_data_module(rc.data)
    jtask = MODEL_FROM_CONFIG_NAME[type(rc.model).__name__](rc.model, jspec, rc.data)
    monkeypatch.setattr(jtask, "init_variables", lambda rng, imgs: params)
    jsugg, jlrs, jlosses = JTrainer(JPLConfig(gpus=1), rc.train).lr_find(jtask, jdm, **kw)

    prc = to_port(rc)
    tdm, tspec = t_get_data_module(prc.data)
    task = ttrain.build_task(prc.model, tspec, prc.data, device="cpu")
    state = state_dict_from_flax(params)
    monkeypatch.setattr(task.model, "reset_parameters",
                        lambda generator: task.model.load_state_dict(state))
    before = {k: v.clone() for k, v in task.model.state_dict().items()}
    sugg, lrs, losses = TTrainer(ttc.PLConfig(), prc.train, device="cpu").lr_find(
        task, tdm, **kw)
    assert len(lrs) == len(jlrs) == LR_STEPS
    np.testing.assert_allclose(lrs, jlrs, **LR_TOL)
    np.testing.assert_allclose(losses, jlosses, **LOSS_TOL)
    assert sugg == jsugg and sugg is not None
    after = task.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)  # weights restored


def test_cli_train_and_resume(world, paths):
    """``python3 -m heal_swin_torch.cli train`` and ``resume`` on the CPU, as a user runs
    them: exit code 0, one run id line each, the resumed run's one epoch."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root, cfg, _, tpath, _ = world
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]),
               HEAL_SWIN_DATA_ROOT=str(root / "data"), HEAL_SWIN_MLRUNS=str(paths / "mlruns"),
               ENTRY_TEST_WEIGHTS=str(tpath), ENTRY_TEST_EPOCHS="1")
    ids = []
    for cmd in ("train", "resume"):
        proc = subprocess.run([sys.executable, "-m", "heal_swin_torch.cli", cmd, "--config_path",
                               str(cfg), "--device", "cpu"], env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        ids += re.findall(r"This run has id (\w+)", proc.stdout)
        env.update(RUN_ID=ids[-1], ENTRY_TEST_EPOCHS="2")
    assert len(ids) == 2
    store = TStore(paths / "mlruns")
    assert [v for _, v, _ in store.get_run(ids[0]).get_metric_history("epoch")] == [0]
    assert [v for _, v, _ in store.get_run(ids[1]).get_metric_history("epoch")] == [1]
    assert store.get_run(ids[1]).status == "FINISHED"


def test_eval_after_train_raises_before_any_work(world, paths, capsys, monkeypatch):
    """``eval_after_train=True`` evaluates the fitted run in the same process (validation
    and the base writer's overlays, ``evaluate_best_*``); more than one GPU raises before
    any file is written."""
    root, cfg, _, tpath, _ = world
    monkeypatch.setenv("ENTRY_TEST_WEIGHTS", str(tpath))
    rc = get_config_from_config_path(cfg, "get_train_run_config")
    rc = dataclasses.replace(rc, train=dataclasses.replace(rc.train, eval_after_train=True))
    run_id, _ = ttrain.train_model(rc, ttc.PLConfig(**dict(PL, max_epochs=1)), config_path=cfg,
                                   device="cpu")
    assert "Evaluation finished." in capsys.readouterr().out
    run = TStore(paths / "mlruns").get_run(run_id)
    assert run.status == "FINISHED"
    for name in ("evaluate_best_val_loss", "evaluate_best_val_iou_global",
                 "evaluate_best_val_acc"):
        assert run.get_metric_history(name), name
    assert len(list(run.artifact_dir.glob("evaluate_best_val_*_iou=*.png"))) == 4
    empty = paths / "data"
    empty.mkdir()
    before = set(paths.rglob("*"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HEAL_SWIN_DATA_ROOT", str(empty))
        with pytest.raises(NotImplementedError, match="queue 1 item 6"):
            ttrain.train_model(rc, ttc.PLConfig(**dict(PL, gpus=2)), config_path=cfg,
                               device="cpu")
    assert set(paths.rglob("*")) == before


def test_auto_lr_find_fits_at_the_suggestion(world, paths, monkeypatch):
    root, cfg, _, tpath, _ = world
    monkeypatch.setenv("ENTRY_TEST_WEIGHTS", str(tpath))
    rc = get_config_from_config_path(cfg, "get_train_run_config")
    run_id, _ = ttrain.train_model(rc, ttc.PLConfig(**dict(PL, max_epochs=1,
                                                           auto_lr_find=True)),
                                   device="cpu")
    run = TStore(paths / "mlruns").get_run(run_id)
    lr = float(param_value(run, "auto_lr_find.lr"))
    assert 1e-8 <= lr <= 1.0
    assert run.get_metric_history("lr-Adam")[-1][1] == pytest.approx(lr, rel=1e-6)
