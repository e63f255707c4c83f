"""The port's checkpoint manager (``heal_swin_torch/training/checkpoint.py``), the cases
of ``tests/test_checkpoint_manager.py`` on torch state: top-k rotation and hard links
with asynchronous saves, ``last.ckpt`` not clobbering earlier epoch files, a worker's
error raised at ``flush``, sync mode, the snapshot surviving in-place updates of the
state it was taken from; ``find_checkpoint``'s selectors and
``utils.check_and_get_ckpt_paths``; and the file format: ``weights_only`` loads, meta
scalars made plain."""

import threading

import numpy as np
import pytest
import torch

from heal_swin_torch.training import checkpoint as ckpt
from heal_swin_torch.utils import utils


def _state(val):
    model = {"w": torch.full((4, 4), val), "b": torch.zeros(4)}
    opt = {"state": {0: {"step": torch.tensor(float(val)), "exp_avg": torch.full((4, 4), 2 * val)}},
           "param_groups": [{"lr": 1e-3, "betas": (0.9, 0.999), "params": [0]}]}
    return model, opt


def test_async_rotation_and_hardlinks(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, monitor="m", mode="max", save_top_k=2)
    for epoch, m in enumerate([0.1, 0.5, 0.3, 0.7]):
        mgr.save_epoch(epoch, {"m": m}, *_state(float(epoch)), {"run_id": "r"})
    best = mgr.finalize_best()
    names = sorted(p.name for p in tmp_path.glob("*.ckpt"))
    assert names == ["best.ckpt", "epoch=1_m=0.5000.ckpt", "epoch=3_m=0.7000.ckpt",
                     "last.ckpt"]
    model, opt, meta = ckpt.load_checkpoint(best)
    assert meta["epoch"] == 3 and meta["metrics"]["m"] == 0.7 and meta["run_id"] == "r"
    assert float(model["w"][0, 0]) == 3.0 and float(opt["state"][0]["exp_avg"][0, 0]) == 6.0
    assert opt["param_groups"][0]["betas"] == (0.9, 0.999)
    # the epoch file is a hard link to last.ckpt's bytes
    assert (tmp_path / "epoch=3_m=0.7000.ckpt").stat().st_ino == (tmp_path / "last.ckpt").stat().st_ino
    assert mgr.flush_seconds >= 0.0
    assert not any(t.name.startswith("ckpt-save") for t in threading.enumerate())


def test_last_not_clobbered_by_later_epochs(tmp_path):
    """The os.replace of last.ckpt leaves the earlier, hard-linked epoch files as they
    were."""
    mgr = ckpt.CheckpointManager(tmp_path, monitor="m", mode="min", save_top_k=3)
    for epoch in range(3):
        mgr.save_epoch(epoch, {"m": 1.0 + 0.1 * epoch}, *_state(float(epoch)), {})
    mgr.flush()
    model, _, meta = ckpt.load_checkpoint(tmp_path / "epoch=0_m=1.0000.ckpt")
    assert meta["epoch"] == 0 and float(model["w"][0, 0]) == 0.0
    _, _, meta_last = ckpt.load_checkpoint(tmp_path / "last.ckpt")
    assert meta_last["epoch"] == 2


def test_worker_error_surfaces_on_flush(tmp_path, monkeypatch):
    mgr = ckpt.CheckpointManager(tmp_path, monitor="m")

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", boom)
    mgr.save_epoch(0, {"m": 0.1}, *_state(0.0), {})
    with pytest.raises(OSError, match="disk full"):
        mgr.flush()
    mgr.flush()  # raised once


def test_sync_mode(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, monitor="m", async_save=False)
    mgr.save_epoch(0, {"m": 0.9}, *_state(5.0), {})
    assert (tmp_path / "last.ckpt").exists()
    assert (tmp_path / "epoch=0_m=0.9000.ckpt").exists()
    assert mgr._pending is None


def test_snapshot_survives_in_place_updates(tmp_path):
    """The save is taken at ``save_epoch``: updating the state in place right after
    (as the next train step does) leaves the checkpoint as it was."""
    model, opt = _state(1.0)
    mgr = ckpt.CheckpointManager(tmp_path, monitor="m")
    mgr.save_epoch(0, {"m": 0.5}, model, opt, {})
    model["w"].add_(100.0)
    opt["state"][0]["exp_avg"].mul_(0.0)
    mgr.flush()
    got, got_opt, _ = ckpt.load_checkpoint(tmp_path / "last.ckpt")
    assert torch.equal(got["w"], torch.full((4, 4), 1.0))
    assert torch.equal(got_opt["state"][0]["exp_avg"], torch.full((4, 4), 2.0))


def test_meta_scalars_are_plain_and_load_weights_only(tmp_path):
    meta = {"metrics": {"a": np.float32(0.25), "b": torch.tensor(3.0)}, "global_step": np.int64(7),
            "scheduler": {"lr": 1e-3, "best": float("inf"), "num_bad_epochs": 0}}
    ckpt.save_checkpoint(tmp_path / "x.ckpt", *_state(2.0), meta)
    _, _, got = ckpt.load_checkpoint(tmp_path / "x.ckpt")
    assert got["metrics"] == {"a": 0.25, "b": 3.0} and got["global_step"] == 7
    assert type(got["global_step"]) is int and got["scheduler"]["best"] == float("inf")
    raw = torch.load(tmp_path / "x.ckpt", weights_only=True)
    assert set(raw) == {"state_dict", "optimizer", "meta"}


@pytest.fixture
def artifacts(tmp_path):
    d = tmp_path / "artifacts" / "checkpoints"
    mgr = ckpt.CheckpointManager(d, monitor="m", mode="max", save_top_k=2)
    for epoch, m in enumerate([0.2, 0.6, 0.4]):
        mgr.save_epoch(epoch, {"m": m}, *_state(float(epoch)), {})
    mgr.flush()
    return tmp_path / "artifacts", mgr


@pytest.mark.parametrize("selector,number,epoch", [
    ("best", None, 1), ("last", None, 2), ("number", "2", 2), ("number", "1", 1),
])
def test_find_checkpoint_selectors(artifacts, selector, number, epoch):
    root, mgr = artifacts
    if selector == "best":
        mgr.finalize_best()
    path = ckpt.find_checkpoint(root, epoch=selector, epoch_number=number)
    assert ckpt.load_checkpoint(path)[2]["epoch"] == epoch
    got, art, run_id = utils.check_and_get_ckpt_paths(str(path))
    assert got == path and art == root and run_id is None


def test_find_checkpoint_best_falls_back_to_last_and_misses_raise(artifacts, tmp_path):
    root, _ = artifacts
    assert ckpt.find_checkpoint(root, "best").name == "last.ckpt"  # no best.ckpt yet
    with pytest.raises(FileNotFoundError, match="epoch=0"):
        ckpt.find_checkpoint(root, "number", "0")  # rotated out of the top 2
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ckpt.find_checkpoint(tmp_path / "empty")
    with pytest.raises(ValueError, match="unknown epoch selector"):
        ckpt.find_checkpoint(root, "worst")
