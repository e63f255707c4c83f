"""The port's ``Trainer.fit`` against the JAX package's on the CPU, at the shape of
``run_configs/swin_hp_test_run_config.py`` (nside 32, embed 4, window 16, depths [2, 1],
batch 1, the synthetic datamodule), and its features.

- (a) Fit against fit: 2 epochs x 2 batches with sanity and epoch validation and
  ReduceLROnPlateau (monitor val_loss, patience 0, a threshold no epoch meets, so that
  the rate halves after every epoch), from the same weights (``resume_state``; the
  port's through ``state_dict_from_flax``), on the same batches (the synthetic arrays
  equal), dropout and DropPath 0 (the frameworks' RNGs differ).  Every logged metric
  within ``FIT_TOL`` (the fused tail's plain version against the JAX task's unfused
  tail, and the same f32 network in another order: measured <= 1.4e-7 relative, the
  accuracies and per-class IoUs equal), the learning rates exactly (the JAX trainer's
  within f32 rounding), the final parameters within ``PARAM_TOL`` (4 Adam steps at
  1e-3; measured <= 2.4e-7 absolute) and the Adam moments within ``MOMENT_TOL`` of
  their largest entry (measured 3.5e-5).
- (b) Resume against an uninterrupted run: 2 epochs, against 1 epoch and a resume from
  ``last.ckpt``, DropPath 0.1 active and the scheduler moving the rate: parameters,
  optimizer state, step losses and every epoch metric but the clock's ``torch.equal``.
- (c) A JAX ``last.ckpt`` resumed in the port: the JAX fit's checkpoint after epoch 0,
  read with flax serialization, turned into the port's state by
  ``adam_state_from_optax`` + ``state_dict_from_flax``; the port's epoch 1 against the
  JAX resume of the same file, within (a)'s limits.  Both take the checkpoint's
  scheduler state, saved by the JAX trainer before the epoch's scheduler step, so both
  repeat epoch 0's rate where the uninterrupted run halves it.
- (d) The features of ``tests/test_trainer_features.py``: ``max_steps``,
  ``terminate_on_nan``, early-stopping patience, ``min_epochs``, mid-epoch
  ``val_check_interval``, the ignored-field warning, gradient accumulation equal to the
  bigger batch (``MultiSteps``), clipping; and ``adam_state_from_optax`` on a live optax
  state against the port's own Adam after the same steps.
- (e) The schedulers: given one metric stream, the JAX schedulers' rates exactly, and
  their state round trip.
"""

import dataclasses
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import heal_swin_torch.data.data_config as tdc
import heal_swin_torch.models.swin_hp as tswin
import heal_swin_torch.models.tasks as ttasks
import heal_swin_torch.training.optimizer as topt
import heal_swin_torch.training.train_config as ttc
from heal_swin_torch.convert import adam_state_from_optax, state_dict_from_flax
from heal_swin_torch.data.data import get_data_module as t_get_data_module
from heal_swin_torch.tracking.mlflow_store import MlflowFileStore as TStore
from heal_swin_torch.training import checkpoint as tckpt
from heal_swin_torch.training.trainer import Trainer as TTrainer
from heal_swin_tpu.data.data import get_data_module as j_get_data_module
from heal_swin_tpu.models.tasks import MODEL_FROM_CONFIG_NAME
from heal_swin_tpu.tracking.mlflow_store import MlflowFileStore as JStore
from heal_swin_tpu.training import optimizer as jopt
from heal_swin_tpu.training.train_config import PLConfig as JPLConfig
from heal_swin_tpu.training.trainer import Trainer as JTrainer
from heal_swin_tpu.utils.utils import get_config_from_config_path

CONFIG = "run_configs/swin_hp_test_run_config.py"
FIT_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=2e-6)
MOMENT_TOL = 2e-4  # each Adam moment, normalized by its largest entry
CLOCK = ("train_time_per_sample in ms",)
DET = dict(drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0)
# halves the rate after every epoch: best * (1 - 1.5) is -inf at the start, so no
# val_loss is ever "better"
PLATEAU = dict(scheduler="reduce_on_plateau", scheduler_monitor="val_loss",
               scheduler_threshold=1.5, scheduler_patience=0, scheduler_factor=0.5)
PORT_CLASSES = {c.__name__: c for m in (tdc, tswin, ttasks, topt, ttc)
                for c in vars(m).values() if dataclasses.is_dataclass(c)}


def to_port(obj):
    """A JAX-package config dataclass as the port's class of the same name."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = PORT_CLASSES[type(obj).__name__]
        return cls(**{f.name: to_port(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, list):
        return [to_port(v) for v in obj]
    return obj


def run_config(model_tweaks=None, opt_tweaks=None, data_tweaks=None, train_tweaks=None):
    """The JAX test run config with ``tweaks`` on its model / optimizer / data-common
    / train configs."""
    rc = get_config_from_config_path(CONFIG, "get_train_run_config")
    mc = rc.model
    inner = dataclasses.replace(mc.swin_hp_transformer_config, **(model_tweaks or {}))
    opt = dataclasses.replace(mc.optimizer_config, **(opt_tweaks or {}))
    data = dataclasses.replace(
        rc.data, common=dataclasses.replace(rc.data.common, **(data_tweaks or {})))
    return dataclasses.replace(
        rc, model=dataclasses.replace(mc, swin_hp_transformer_config=inner,
                                      optimizer_config=opt),
        data=data, train=dataclasses.replace(rc.train, **(train_tweaks or {})))


def port_fit(tmp_path, rc, pl, resume_state=None, name="run", nan_loss=False):
    """The port's fit of JAX-package run config ``rc`` under PLConfig fields ``pl``:
    (trainer, result, task, tracking run)."""
    prc = to_port(rc)
    dm, spec = t_get_data_module(prc.data)
    task = ttasks.WoodscapeSegmenterSwinHP(prc.model, spec, device="cpu")
    if nan_loss:
        orig = task.loss_fn
        task.loss_fn = lambda *a, **kw: (lambda lo: (lo[0] * math.nan, lo[1]))(orig(*a, **kw))
    run = TStore(tmp_path / "mlruns").create_run(name)
    trainer = TTrainer(ttc.PLConfig(**pl), prc.train, run=run,
                       ckpt_dir=run.artifact_dir / "checkpoints", device="cpu")
    result = trainer.fit(task, dm, resume_state=resume_state)
    return trainer, result, task, run


def jax_fit(tmp_path, rc, pl, resume_state=None, name="jrun"):
    dm, spec = j_get_data_module(rc.data)
    task = MODEL_FROM_CONFIG_NAME[type(rc.model).__name__](rc.model, spec, rc.data)
    run = JStore(tmp_path / "jmlruns").create_run(name)
    trainer = JTrainer(JPLConfig(gpus=1, **pl), rc.train, run=run,
                       ckpt_dir=run.artifact_dir / "checkpoints")
    result = trainer.fit(task, dm, resume_state=resume_state)
    return trainer, result, task, run, dm


def history(run):
    """{metric: [(step, value), ...]} of a tracking run."""
    names = sorted(p.name for p in (run.run_dir / "metrics").iterdir())
    return {n: [(s, v) for _, v, s in run.get_metric_history(n)] for n in names}


def close_histories(got, want, tol=FIT_TOL, skip=CLOCK):
    assert set(got) == set(want)
    for name in want:
        if name in skip:
            continue
        g, w = np.asarray(got[name], np.float64), np.asarray(want[name], np.float64)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g[:, 0], w[:, 0], err_msg=name)
        np.testing.assert_allclose(g[:, 1], w[:, 1], err_msg=name, **tol)


def close_params(model, jax_params, tol=PARAM_TOL):
    want = state_dict_from_flax(jax.tree.map(np.asarray, jax.device_get(jax_params)))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **tol)


def close_moments(run, jrun, trainer, task):
    """The Adam state in the two runs' last.ckpt: the step counts equal, each moment
    within MOMENT_TOL of its largest entry.  Returns the port checkpoint's meta."""
    _, opt_state, meta = tckpt.load_checkpoint(run.artifact_dir / "checkpoints" / "last.ckpt")
    _, jopt_state, _ = jax_checkpoint(jrun.artifact_dir / "checkpoints" / "last.ckpt")
    want = adam_state_from_optax(jopt_state, task.model, trainer.optimizer)
    for i, st in want["state"].items():
        assert float(opt_state["state"][i]["step"]) == float(st["step"]) == trainer.global_step
        for k in ("exp_avg", "exp_avg_sq"):
            got, want_k = opt_state["state"][i][k].numpy(), st[k].numpy()
            scale = max(float(np.abs(want_k).max()), 1e-30)
            np.testing.assert_allclose(got / scale, want_k / scale, rtol=0,
                                       atol=MOMENT_TOL, err_msg=f"{i} {k}")
    return meta


def jax_checkpoint(path):
    with open(path, "rb") as f:
        state = serialization.msgpack_restore(f.read())
    return state["params"], state["opt_state"], state["meta"]


FIT_PL = dict(max_epochs=2, limit_train_batches=2, limit_val_batches=2,
              num_sanity_val_steps=1, log_every_n_steps=1)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX fit of (a), its weights drawn once and shared: (run config, initial
    params, trainer, tracking run, datamodule, tmp dir)."""
    tmp = tmp_path_factory.mktemp("jaxfit")
    rc = run_config(model_tweaks=DET, opt_tweaks=PLATEAU)
    dm, spec = j_get_data_module(rc.data)
    task = MODEL_FROM_CONFIG_NAME[type(rc.model).__name__](rc.model, spec, rc.data)
    imgs, _ = next(iter(dm.train_dataloader()))
    params = task.init_variables(jax.random.PRNGKey(7), jnp.asarray(imgs[:1]))
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape)
                          .astype(np.float32), params)
    trainer, result, _, run, dm = jax_fit(tmp, rc, FIT_PL, {"params": params})
    return rc, params, trainer, run, dm, tmp


def test_fit_matches_the_jax_fit(jax_run, tmp_path):
    """(a): every logged metric, the rates and the final parameters."""
    rc, params, jtrainer, jrun, jdm, _ = jax_run
    trainer, result, task, run = port_fit(tmp_path, rc, FIT_PL,
                                          {"params": state_dict_from_flax(params)})
    tdm, _ = t_get_data_module(to_port(rc).data)
    for ds in ("train_ds", "val_ds", "pred_ds"):
        for (ti, tm, tn), (ji, jm, jn) in zip(getattr(tdm, ds).samples,
                                              getattr(jdm, ds).samples):
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tm, jm)
            assert tn == jn
    got, want = history(run), history(jrun)
    close_histories(got, want)
    assert [v for _, v in got["lr-Adam"]] == [1e-3, 5e-4]
    np.testing.assert_allclose([v for _, v in want["lr-Adam"]], [1e-3, 5e-4], rtol=1e-7)
    assert [s for s, _ in got["train_loss_step"]] == [1, 2, 3, 4]
    assert result.global_step == 4 and result.epochs_run == 2
    close_params(task.model, jtrainer._params)
    close_moments(run, jrun, trainer, task)
    names = sorted(p.name for p in (run.artifact_dir / "checkpoints").iterdir())
    jnames = sorted(p.name for p in (jrun.artifact_dir / "checkpoints").iterdir())
    assert names == jnames and "best.ckpt" in names and "last.ckpt" in names


def test_jax_checkpoint_resumes_in_the_port(jax_run, tmp_path):
    """(c): the JAX fit's epoch-0 checkpoint, resumed by both packages for epoch 1."""
    rc, _, _, jrun, _, _ = jax_run
    ckdir = jrun.artifact_dir / "checkpoints"
    src = next(ckdir.glob("epoch=0_*.ckpt"))
    _, jres, _, jrun2, _ = jax_fit(tmp_path, rc, dict(FIT_PL, resume_from_checkpoint=str(src)),
                                   name="jresume")
    params, opt_state, meta = jax_checkpoint(src)
    # the port's task and optimizer in the order fit makes them, for the state's keys
    prc = to_port(rc)
    _, spec = t_get_data_module(prc.data)
    task = ttasks.WoodscapeSegmenterSwinHP(prc.model, spec, device="cpu")
    opt = topt.make_optimizer(task.model.parameters(), prc.model.optimizer_config)
    ported = tmp_path / "ported.ckpt"
    tckpt.save_checkpoint(ported, state_dict_from_flax(params),
                          adam_state_from_optax(opt_state, task.model, opt), meta)
    trainer, result, task, run = port_fit(tmp_path, rc,
                                          dict(FIT_PL, resume_from_checkpoint=str(ported)))
    assert result.global_step == jres.global_step == 4
    close_histories(history(run), history(jrun2))
    # both resumes repeat epoch 0's rate: the JAX checkpoint's scheduler state is the
    # state before epoch 0's step (the uninterrupted run halves it)
    assert [v for _, v in history(run)["lr-Adam"]] == [1e-3]
    assert [v for _, v in history(jrun)["lr-Adam"]][1] == pytest.approx(5e-4)
    jparams, _, _ = jax_checkpoint(jrun2.artifact_dir / "checkpoints" / "last.ckpt")
    close_params(task.model, jparams)
    meta = close_moments(run, jrun2, trainer, task)
    assert meta["epoch"] == 1 and meta["global_step"] == 4


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """(b): bit for bit, with DropPath 0.1 active and the scheduler moving the rate."""
    rc = run_config(model_tweaks=dict(drop_path_rate=0.1), opt_tweaks=PLATEAU,
                    train_tweaks=dict(seed=5))
    full, _, task_a, run_a = port_fit(tmp_path / "a", rc, FIT_PL)
    _, res1, _, run_b1 = port_fit(tmp_path / "b", rc, dict(FIT_PL, max_epochs=1))
    assert res1.global_step == 2
    last = run_b1.artifact_dir / "checkpoints" / "last.ckpt"
    resumed, res2, task_b, run_b2 = port_fit(tmp_path / "c", rc,
                                             dict(FIT_PL, resume_from_checkpoint=str(last)))
    assert res2.global_step == 4 and res2.epochs_run == 1
    for k, v in task_a.model.state_dict().items():
        assert torch.equal(v, task_b.model.state_dict()[k]), k
    sa, sb = full.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["param_groups"][0]["lr"] == 2.5e-4  # halved after each of the two epochs
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    ha, hb = history(run_a), history(run_b2)
    assert set(ha) == set(hb)
    for name in ha:
        if name not in CLOCK:
            assert ha[name][-len(hb[name]):] == hb[name], name
    assert [s for s, _ in hb["train_loss_step"]] == [3, 4]


# ------------------------------------------------------------- (d) features
SMALL = dict(limit_train_batches=1, limit_val_batches=1, num_sanity_val_steps=0,
             log_every_n_steps=1)
NEVER_BETTER = dict(early_stopping=True, early_stopping_monitor="val_loss",
                    early_stopping_mode="min", early_stopping_patience=1,
                    early_stopping_min_delta=1e9)


@pytest.mark.parametrize("pl,train,epochs,steps", [
    (dict(max_epochs=5, max_steps=3, limit_train_batches=2, limit_val_batches=1,
          num_sanity_val_steps=0, log_every_n_steps=1), None, 2, 3),  # max_steps
    (dict(max_epochs=6, **SMALL), NEVER_BETTER, 2, 2),  # patience trips at epoch 1
    (dict(max_epochs=6, min_epochs=4, **SMALL), NEVER_BETTER, 4, 4),  # min_epochs holds
], ids=["max_steps", "early_stopping", "min_epochs"])
def test_stopping(tmp_path, pl, train, epochs, steps):
    rc = run_config(train_tweaks=train)
    trainer, result, _, _ = port_fit(tmp_path, rc, pl)
    assert (result.epochs_run, trainer.global_step) == (epochs, steps)


def test_terminate_on_nan_raises(tmp_path):
    pl = dict(max_epochs=1, limit_train_batches=2, limit_val_batches=1,
              num_sanity_val_steps=0, terminate_on_nan=True, log_every_n_steps=1)
    with pytest.raises(FloatingPointError, match="non-finite train loss"):
        port_fit(tmp_path, run_config(), pl, nan_loss=True)


def test_val_check_interval_mid_epoch(tmp_path):
    """0.5 validates after batch 2 (50%) and at the epoch's end."""
    pl = dict(max_epochs=1, limit_train_batches=4, limit_val_batches=1,
              val_check_interval=0.5, num_sanity_val_steps=0, log_every_n_steps=10 ** 6)
    trainer, _, _, run = port_fit(tmp_path, run_config(), pl)
    assert [s for _, _, s in run.get_metric_history("val_loss")] == [2, 4]


def test_warn_on_ignored_pl_fields():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        bad = ttc.warn_ignored_fields(ttc.PLConfig(num_processes=4, sync_batchnorm=True))
    assert sorted(bad) == ["num_processes", "sync_batchnorm"]
    assert len(w) == 1 and "num_processes" in str(w[0].message)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ok = ttc.warn_ignored_fields(
            ttc.PLConfig(max_steps=5, val_check_interval=0.5, gradient_clip_val=1.0))
    assert ok == [] and len(w) == 0
    assert ttc.HONORED_FIELDS == __import__(
        "heal_swin_tpu.training.train_config", fromlist=["x"]).HONORED_FIELDS


@pytest.mark.parametrize("pl", [dict(gpus=2), dict(num_nodes=2), dict(seq_parallel_devices=2)])
def test_more_than_one_device_raises(pl):
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        TTrainer(ttc.PLConfig(**pl), device="cpu")


def test_grad_accumulation_matches_bigger_batch(tmp_path):
    """accumulate_grad_batches=2 at batch 2 equals one step at batch 4 (MultiSteps
    averages the micro-batch gradients; the losses are batch means)."""
    pl = dict(max_epochs=1, limit_val_batches=1, num_sanity_val_steps=0,
              log_every_n_steps=100)
    acc, _, task_a, _ = port_fit(tmp_path / "a", run_config(DET, data_tweaks=dict(
        batch_size=2)), dict(pl, limit_train_batches=2, accumulate_grad_batches=2))
    _, _, task_b, _ = port_fit(tmp_path / "b", run_config(DET, data_tweaks=dict(
        batch_size=4)), dict(pl, limit_train_batches=1))
    assert isinstance(acc.optimizer, topt.MultiSteps)
    assert float(acc.optimizer.inner.state_dict()["state"][0]["step"]) == 1.0
    moved = 0
    for k, b in task_b.model.state_dict().items():
        a = task_a.model.state_dict()[k]
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=1e-6, err_msg=k)
        moved += int(not torch.equal(a, b))
    assert moved > 0


def test_clipping_clips_and_the_rate_stays_settable():
    """gradient_clip_val > 0: huge gradients come out clipped to the global norm (the
    Adam step stays bounded), and the learning rate stays settable."""
    w = torch.nn.Parameter(torch.zeros(8, 8))
    opt = topt.make_optimizer([w], topt.OptimizerConfig(learning_rate=1.0),
                              gradient_clip_val=1.0)
    w.grad = torch.full((8, 8), 1e6)
    opt.step()
    assert float(torch.linalg.vector_norm(w.grad)) == pytest.approx(1.0, rel=1e-6)
    assert float(w.detach().abs().max()) < 10.0
    topt.set_learning_rate(opt, 0.5)
    assert topt.get_learning_rate(opt) == 0.5


def test_adam_state_from_optax_continues_a_live_optax_run():
    """Two optax Adam steps (inject_hyperparams, weight decay), their state carried
    into torch's Adam: its third step gives the parameters of optax's third step."""
    jcfg = jopt.OptimizerConfig(learning_rate=3e-3, weight_decay=1e-2)
    rc = run_config()
    prc = to_port(rc)
    _, spec = t_get_data_module(prc.data)
    task = ttasks.WoodscapeSegmenterSwinHP(prc.model, spec, device="cpu")
    rng = np.random.default_rng(0)
    jtask = MODEL_FROM_CONFIG_NAME[type(rc.model).__name__](rc.model, spec, rc.data)
    params = jtask.init_variables(jax.random.PRNGKey(0), jnp.zeros((1, spec.dim_in, 3)))
    params = jax.tree.map(np.asarray, params)
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
             for _ in range(3)]
    tx = jopt.make_optimizer(jcfg)
    state = tx.init(params)
    p = params
    for g in grads[:2]:
        upd, state = tx.update(g, state, p)
        p = optax.apply_updates(p, upd)
    task.model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, p)))
    opt = topt.make_optimizer(task.model.parameters(),
                              topt.OptimizerConfig(learning_rate=1.0, weight_decay=1e-2))
    opt.load_state_dict(adam_state_from_optax(jax.device_get(state), task.model, opt))
    assert topt.get_learning_rate(opt) == pytest.approx(3e-3, rel=1e-7)
    g3 = state_dict_from_flax(grads[2])
    for name, prm in task.model.named_parameters():
        prm.grad = g3[name].clone()
    opt.step()
    upd, state = tx.update(grads[2], state, p)
    close_params(task.model, optax.apply_updates(p, upd), tol=dict(rtol=1e-5, atol=1e-7))


# ----------------------------------------------------------- (e) schedulers
STREAM = [1.0, 0.9, 0.95, 0.95, 0.96, 0.5, 0.5, 0.49995, 0.7, 0.8, 0.9, 0.2, 0.3]


@pytest.mark.parametrize("cfg", [
    dict(scheduler="reduce_on_plateau", scheduler_mode="min", scheduler_patience=1),
    dict(scheduler="reduce_on_plateau", scheduler_mode="max", scheduler_patience=0,
         scheduler_factor=0.3, scheduler_min_lr=1e-4),
    dict(scheduler="reduce_on_plateau", scheduler_mode="min", scheduler_patience=2,
         scheduler_threshold=1e-3, scheduler_monitor="val_loss"),
    dict(scheduler="exponential", scheduler_factor=0.7),
    dict(scheduler=None),
], ids=["plateau_min", "plateau_max", "plateau_threshold", "exponential", "none"])
def test_schedulers_match_the_jax_schedulers(cfg):
    t = topt.make_scheduler(topt.OptimizerConfig(learning_rate=0.01, **cfg))
    j = jopt.make_scheduler(jopt.OptimizerConfig(learning_rate=0.01, **cfg))
    if cfg["scheduler"] is None:
        assert t is None and j is None
        return
    got, want = [], []
    for i, v in enumerate(STREAM):
        m = {"train_loss": v, "val_loss": 2 * v} if i != 4 else {}  # a missing monitor
        got.append(t.step(m))
        want.append(j.step(m))
        if i == 6:  # a resume mid-stream
            t2 = topt.make_scheduler(topt.OptimizerConfig(learning_rate=0.01, **cfg))
            t2.load_state_dict(t.state_dict())
            assert t2.state_dict() == t.state_dict() == j.state_dict()
            t = t2
    assert got == want
    assert len(set(got)) > 1
