"""The trainer's CUDA paths, on a GPU: ``Trainer._device_prefetch`` (pinned buffers
staged by a background thread on a side stream), the checkpoint manager's device
snapshot and side-stream host copy, and a small fit resumed bit for bit.

These tests skip without a CUDA device.  On a GPU host without JAX run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_trainer.py
"""

import threading
import time

import numpy as np
import pytest
import torch

from heal_swin_torch.data.data import get_data_module
from heal_swin_torch.data.data_config import WoodscapeCommonConfig, WoodscapeHPConfig
from heal_swin_torch.models.swin_hp import SwinHPTransformerConfig
from heal_swin_torch.models.tasks import (WoodscapeSegmenterSwinHP,
                                          WoodscapeSegmenterSwinHPConfig)
from heal_swin_torch.training import checkpoint as ckpt
from heal_swin_torch.training.train_config import PLConfig, TrainConfig
from heal_swin_torch.training.trainer import Trainer

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _batches(n, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise ValueError(f"batch {i} failed")
        yield (np.full((2, 1000), i, np.float32), {"t": np.arange(3, dtype=np.int32) + i}), i


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "device-prefetch"]


def test_device_prefetch_order_values_and_errors(dev):
    trainer = Trainer(PLConfig(), device=dev)
    got = []
    for (x, t), i in trainer._device_prefetch(_batches(7)):
        assert x.is_cuda and t["t"].is_cuda
        assert torch.equal(x.cpu(), torch.full((2, 1000), float(i)))
        got.append((int(t["t"][0]), i))
    assert got == [(i, i) for i in range(7)]
    with pytest.raises(ValueError, match="batch 3 failed"):
        list(trainer._device_prefetch(_batches(7, fail_at=3)))
    it = trainer._device_prefetch(_batches(50))
    next(it)
    it.close()  # an early exit stops the staging thread
    deadline = time.time() + 5
    while _prefetch_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not _prefetch_threads()


def test_checkpoint_snapshot_of_device_state(dev, tmp_path):
    """The async save copies the device state on the training stream; updates queued
    after it on that stream leave the checkpoint as it was."""
    model = {"w": torch.full((256, 256), 1.0, device=dev)}
    opt = {"state": {0: {"step": torch.tensor(3.0), "exp_avg": torch.full((256,), 2.0, device=dev)}},
           "param_groups": [{"lr": 1e-3, "params": [0]}]}
    mgr = ckpt.CheckpointManager(tmp_path, monitor="m")
    torch.cuda._sleep(50_000_000)  # the update below runs after a long device wait
    mgr.save_epoch(0, {"m": 1.0}, model, opt, {})
    model["w"].add_(5.0)
    opt["state"][0]["exp_avg"].zero_()
    mgr.finalize_best()
    got, got_opt, meta = ckpt.load_checkpoint(tmp_path / "last.ckpt")
    assert torch.equal(got["w"], torch.ones(256, 256))
    assert torch.equal(got_opt["state"][0]["exp_avg"], torch.full((256,), 2.0))
    assert meta["epoch"] == 0 and (tmp_path / "best.ckpt").exists()


def _fit(tmp_path, dev, **pl):
    dm, spec = get_data_module(WoodscapeHPConfig(common=WoodscapeCommonConfig(
        version="synthetic", batch_size=2, val_batch_size=2, synthetic_train_samples=8,
        synthetic_val_samples=4), input_nside=32))
    task = WoodscapeSegmenterSwinHP(WoodscapeSegmenterSwinHPConfig(SwinHPTransformerConfig(
        window_size=16, shift_size=8, shift_strategy="ring_shift", embed_dim=8,
        depths=[2, 1], num_heads=[2, 2], attention_impl="xla")), spec, device=dev)
    trainer = Trainer(PLConfig(num_sanity_val_steps=1, log_every_n_steps=1, **pl),
                      TrainConfig(seed=3), ckpt_dir=tmp_path, device=dev)
    trainer.fit(task, dm)
    return trainer, task


def test_small_fit_resumes_bit_for_bit(dev, tmp_path):
    full, task_a = _fit(tmp_path / "a", dev, max_epochs=2)
    _fit(tmp_path / "b", dev, max_epochs=1)
    resumed, task_b = _fit(tmp_path / "c", dev, max_epochs=2,
                           resume_from_checkpoint=str(tmp_path / "b" / "last.ckpt"))
    assert full.global_step == resumed.global_step == 8
    for k, v in task_a.model.state_dict().items():
        assert torch.equal(v, task_b.model.state_dict()[k]), k
    assert full.last_train_steady_samples == 6 and full.last_train_steady_time > 0
