"""The paper configs' f32 forward in eval mode, and the eval half of the trainer, against
the JAX package on the CPU.

The models are the NSIDE 8 ones of ``test_torch_dropout.py`` (segmentation: the paper
config's options -- cosine attention, v2 norms, dropout, attention dropout and DropPath
0.1, inactive at eval -- at window 16, embed 8, depths [2, 1]) and of
``test_torch_depth_tail_f32.py`` (the depth paper config cut the same way), in float32,
with the same numpy-seeded weights in both packages (``convert.py``).  The fused tails
run the Pallas kernels in interpret mode (``HEAL_SWIN_FH_INTERPRET=1``) on the JAX side
and their plain versions here.  Every value within 2e-5 (relative and absolute):

- segmentation ``loss_fn`` in eval, without a sample mask (the fused tail: loss and
  confusion matrix) and with one sample masked (the unfused tail, as the JAX task's
  gate sends it), and its metric update;
- depth ``loss_fn`` in eval with a sample mask (the fused tail, the padded sample's
  targets inf, and the unfused one), and its metric update;
- both tasks' ``predict``: the classes equal, the metric depths close;
- ``pad_batch`` against ``Trainer._pad_batch`` at dp 1 and 2, targets an array and a
  tuple of arrays;
- ``run_validation`` over 3 ragged batches (2, 2 and 1 samples, padded to dp 2) against
  the JAX task's ``loss_fn`` / ``metric_update`` / ``metric_compute`` composed under
  the same padding and masks, ``val_loss`` = sum(loss * valid) / sum(valid);
- the predict loop hands the writer every batch's host predictions in order, its
  predict function, and the epoch's end; without a writer it returns them.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch.training import trainer as ttrainer
from heal_swin_tpu.training.trainer import Trainer
from tests.test_torch_depth_tail_f32 import _depth_batch, _depth_tasks
from tests.test_torch_dropout import _batch, _cfg_kwargs, _tasks

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("HEAL_SWIN_FH_INTERPRET", "1")


def _close_states(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k].numpy(), np.float64),
                                   np.asarray(want[k], np.float64), err_msg=k, **TOL)


def _close_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def _mask(masked):
    return np.array([True, False]) if masked else None


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("masked", [False, True], ids=["fused", "masked"])
def test_segmentation_eval_loss_and_metrics_match_jax(interpret, masked):
    jtask, params, ttask = _tasks(_cfg_kwargs())
    imgs, targets = _batch(11)
    mask = _mask(masked)
    with torch.no_grad():  # as eval_step
        loss_t, out_t = ttask.loss_fn(_t(imgs), _t(targets), sample_mask=_t(mask))
    loss_j, out_j = jtask.loss_fn(params, _j(imgs), _j(targets), deterministic=True,
                                  sample_mask=_j(mask))
    F = ttask.num_classes
    assert tuple(out_t.shape) == tuple(out_j.shape) == ((2, imgs.shape[1], F) if masked
                                                         else (F, F))
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    st = ttask.metric_update(ttask.metric_init(), out_t, _t(targets), sample_mask=_t(mask))
    sj = jtask.metric_update(jtask.metric_init(), out_j, _j(targets), sample_mask=_j(mask))
    _close_states(st, sj)
    assert float(st["total"]) == (imgs.shape[1] if masked else 2 * imgs.shape[1])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_depth_eval_loss_with_a_sample_mask_matches_jax(interpret, fused):
    jtask, params, ttask = _depth_tasks(fused)
    assert ttask._fused_tail_ok() == jtask._fused_tail_ok() == fused
    imgs, targets = _depth_batch(12, jtask)
    mask = np.array([False, True])
    with torch.no_grad():  # as eval_step
        loss_t, out_t = ttask.loss_fn(_t(imgs), _t(targets), sample_mask=_t(mask))
    loss_j, out_j = jtask.loss_fn(params, _j(imgs), _j(targets), deterministic=True,
                                  sample_mask=_j(mask))
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    st = ttask.metric_update(ttask.metric_init(), out_t, _t(targets), sample_mask=_t(mask))
    sj = jtask.metric_update(jtask.metric_init(), out_j, _j(targets), sample_mask=_j(mask))
    _close_states(st, sj)
    assert float(st["count"]) == np.isfinite(targets[1]).sum()


def test_predict_matches_jax(interpret):
    jtask, params, ttask = _tasks(_cfg_kwargs())
    imgs, _ = _batch(13)
    got = ttask.predict(None, _t(imgs))
    want = np.asarray(jtask.predict(params, _j(imgs)))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)

    jdepth, dparams, tdepth = _depth_tasks(True)
    dimgs, _ = _depth_batch(14, jdepth)
    got = tdepth.predict(None, _t(dimgs))
    want = np.asarray(jdepth.predict(dparams, _j(dimgs)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, dimgs.shape[1], 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dp", [1, 2])
def test_pad_batch_matches_jax(dp):
    rng = np.random.default_rng(15)
    imgs = rng.normal(size=(3, 8, 3)).astype(np.float32)
    targets = (rng.integers(0, 5, (3, 8)).astype(np.int32), np.arange(3))
    pi, (pm, pc), mask = ttrainer.pad_batch(_t(imgs), tuple(_t(a) for a in targets), dp)
    ji, (jm, jc), jmask = Trainer._pad_batch(SimpleNamespace(dp=dp), imgs, targets)
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_array_equal(pm.numpy(), jm)
    np.testing.assert_array_equal(pc.numpy(), jc)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert mask.dtype == torch.bool and len(mask) == (3 if dp == 1 else 4)
    arr = ttrainer.pad_batch(imgs, targets[0], dp)[1]  # numpy in, a bare array of targets
    np.testing.assert_array_equal(arr.numpy(), jm)


def _ragged(batch_of):
    """Three batches of 2, 2 and 1 samples."""
    out = []
    for i, n in enumerate((2, 2, 1)):
        imgs, targets = batch_of(20 + i)
        out.append((imgs[:n], targets[:n]))
    return out


def _jax_validation(jtask, params, batches, dp):
    """The JAX trainer's validation composed from the task's functions: each batch padded
    as ``Trainer._pad_batch``, ``loss_fn`` in eval under the sample mask, its
    ``metric_update``, then ``metric_compute`` and sum(loss * valid) / sum(valid)."""
    state = jtask.metric_init()
    loss_sum = count = 0.0
    for imgs, targets in batches:
        imgs, targets, mask = Trainer._pad_batch(SimpleNamespace(dp=dp), imgs, targets)
        loss, out = jtask.loss_fn(params, _j(imgs), _j(targets), deterministic=True,
                                  sample_mask=_j(mask))
        state = jtask.metric_update(state, out, _j(targets), sample_mask=_j(mask))
        loss_sum += float(loss) * float(mask.sum())
        count += float(mask.sum())
    metrics = jtask.metric_compute(state, "val_", with_per_class=True)
    metrics["val_loss"] = loss_sum / count
    return metrics


@pytest.mark.parametrize("task", ["segmentation", "depth"])
def test_run_validation_matches_jax(interpret, task):
    if task == "segmentation":
        jtask, params, ttask = _tasks(_cfg_kwargs())
        batches = _ragged(_batch)
    else:
        jtask, params, ttask = _depth_tasks(True)
        batches = _ragged(lambda seed: _depth_batch(seed, jtask))
    want = _jax_validation(jtask, params, batches, dp=2)
    got = ttrainer.run_validation(ttask, iter([(_t(i), _t(t)) for i, t in batches]), dp=2)
    _close_metrics(got.metrics, want)
    assert got.samples == 5.0 and got.steady_samples == 3.0 and got.steady_time >= 0.0
    again = ttrainer.validate(ttask, iter(batches))  # numpy batches, dp 1: no padding
    np.testing.assert_allclose(again.metrics["val_loss"], want["val_loss"], **TOL)


class _Writer:
    def __init__(self):
        self.batches, self.ended, self.fn = [], 0, None

    def set_predict_fn(self, fn):
        self.fn = fn

    def write_on_batch_end(self, preds, batch, i):
        self.batches.append((i, preds, batch["name"]))

    def on_predict_epoch_end(self):
        self.ended += 1


def test_predict_loop_feeds_the_writer(interpret):
    _, _, ttask = _tasks(_cfg_kwargs())
    batches = [dict(hp_imgs=_t(_batch(30 + i)[0]), name=f"b{i}") for i in range(3)]
    want = [ttask.predict(None, b["hp_imgs"]).numpy() for b in batches]
    writer = _Writer()
    run = ttrainer.predict(ttask, iter(batches), writer=writer)
    assert run.outputs is None and run.samples == 6 and run.steady_samples == 4
    assert writer.ended == 1 and [(i, n) for i, _, n in writer.batches] == [
        (0, "b0"), (1, "b1"), (2, "b2")]
    for (_, preds, _), w in zip(writer.batches, want):
        assert isinstance(preds, np.ndarray)
        np.testing.assert_array_equal(preds, w)
    np.testing.assert_array_equal(writer.fn(batches[0]["hp_imgs"]), want[0])
    plain = ttrainer.predict(ttask, iter(batches), params=ttask.model.state_dict(),
                             max_batches=2)
    assert len(plain.outputs) == 2 and plain.samples == 4
    for got, w in zip(plain.outputs, want):
        np.testing.assert_array_equal(got, w)
