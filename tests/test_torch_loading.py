"""The port's host data path against the JAX package's: ``DataLoader``'s batch order,
``indices``, ``drop_last`` and per-epoch reshuffle equal the JAX loader's; its decode
pool is a pure performance knob (the same batches for any ``num_workers``), a decode
error reaches the consumer, and an abandoned iterator leaves no thread behind (the
cases of ``tests/test_loading.py``); ``default_collate`` of dicts; and the synthetic
HEALPix datamodules (segmentation and depth, standardized with the background masked)
give the JAX package's arrays, loaders and data specs."""

import dataclasses
import gc
import threading
import time

import numpy as np
import pytest

from heal_swin_torch.data import data as tdata
from heal_swin_torch.data import data_config as tdc
from heal_swin_torch.data.loading import DataLoader, default_collate
from heal_swin_tpu.data import data as jdata
from heal_swin_tpu.data import data_config as jdc
from heal_swin_tpu.data.loading import DataLoader as JDataLoader


class _Squares:
    """Map-style dataset; its 'decode' sleeps (releasing the GIL) or fails at one
    index."""

    def __init__(self, n=32, delay=0.0, fail_at=None):
        self.n, self.delay, self.fail_at = n, delay, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.fail_at is not None and i == self.fail_at:
            raise ValueError(f"decode failed at {i}")
        if self.delay:
            time.sleep(self.delay)
        return np.full((3,), i * i, dtype=np.int64), np.int32(i)


def _batches(loader, epochs=(0,)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out += [tuple(a.copy() for a in b) for b in loader]
    return out


@pytest.mark.parametrize("kw", [
    dict(batch_size=4), dict(batch_size=4, drop_last=True),
    dict(batch_size=5, shuffle=True, seed=3), dict(batch_size=5, shuffle=True, seed=3,
                                                     drop_last=True),
    dict(batch_size=3, shuffle=True, seed=11, indices=[7, 1, 30, 4, 9, 22, 13]),
    dict(batch_size=2, indices=[5, 3, 8], drop_last=True),
], ids=["plain", "drop_last", "shuffle", "shuffle_drop_last", "indices_shuffle", "indices"])
def test_order_matches_the_jax_loader(kw):
    ds = _Squares(n=37)
    got = _batches(DataLoader(ds, **kw), epochs=(0, 1, 2))
    want = _batches(JDataLoader(ds, **kw), epochs=(0, 1, 2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert len(DataLoader(ds, **kw)) == len(JDataLoader(ds, **kw))
    if kw.get("shuffle"):  # the epoch reshuffles, deterministically
        one = _batches(DataLoader(ds, **kw), epochs=(0,))
        two = _batches(DataLoader(ds, **kw), epochs=(1,))
        assert any(not np.array_equal(a[1], b[1]) for a, b in zip(one, two))


@pytest.mark.parametrize("shuffle", [False, True])
def test_num_workers_is_order_invariant(shuffle):
    ds = _Squares(n=37, delay=0.001)
    ref = _batches(DataLoader(ds, batch_size=4, shuffle=shuffle, seed=3, prefetch=0))
    for workers in (1, 2, 5):
        got = _batches(DataLoader(ds, batch_size=4, shuffle=shuffle, seed=3,
                                  num_workers=workers))
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[0], r[0])


@pytest.mark.parametrize("workers", [0, 1, 3])
def test_decode_exception_propagates(workers):
    loader = DataLoader(_Squares(n=20, fail_at=9), batch_size=4, num_workers=workers)
    with pytest.raises(ValueError, match="decode failed at 9"):
        list(loader)


@pytest.mark.parametrize("workers", [1, 3])
def test_abandoned_iterator_does_not_leak_threads(workers):
    before = threading.active_count()
    loader = DataLoader(_Squares(n=64, delay=0.002), batch_size=2, num_workers=workers,
                        prefetch=2)
    for _ in range(3):
        it = iter(loader)
        next(it)
        del it  # abandoned mid-epoch with the queue full
        gc.collect()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_default_collate_dicts():
    samples = [{"hp_imgs": np.ones((4, 3), np.float32) * i, "names": f"s{i}", "k": i}
               for i in range(3)]
    out = default_collate(samples)
    assert out["hp_imgs"].shape == (3, 4, 3) and list(out["names"]) == ["s0", "s1", "s2"]
    np.testing.assert_array_equal(out["k"], [0, 1, 2])


def _to_port(cfg):
    """A JAX-package data config as the port's class of the same name."""
    if dataclasses.is_dataclass(cfg):
        cls = getattr(tdc, type(cfg).__name__)
        return cls(**{f.name: _to_port(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)})
    return cfg


COMMON = dict(version="synthetic", batch_size=2, val_batch_size=3, pred_batch_size=2,
              synthetic_train_samples=6, synthetic_val_samples=5, train_worker=2)


@pytest.mark.parametrize("depth", [False, True], ids=["segmentation", "depth"])
@pytest.mark.parametrize("common", [{}, dict(manual_overfit_batches=2),
                                    dict(training_data_fraction=0.5)],
                         ids=["all", "overfit", "fraction"])
def test_synthetic_datamodules_match_the_jax_package(depth, common):
    c = jdc.WoodscapeCommonConfig(**COMMON, **common)
    if depth:
        cfg = jdc.WoodscapeHPDepthConfig(
            common=c, input_nside=8, common_depth=jdc.WoodscapeDepthCommonConfig(
                mask_background=True, normalize_data="standardize"))
    else:
        cfg = jdc.WoodscapeHPConfig(common=c, input_nside=8)
    jdm, jspec = jdata.get_data_module(cfg)
    tdm, tspec = tdata.get_data_module(_to_port(cfg))
    for k in ("dim_in", "f_in", "f_out", "base_pix", "class_names"):
        assert getattr(tspec, k) == getattr(jspec, k), k
    if depth:
        assert vars(tspec.data_stats) == vars(jspec.data_stats)
    np.testing.assert_array_equal(tdm.train_indices, jdm.train_indices)
    for which in ("train_dataloader", "val_dataloader", "predict_dataloader"):
        tl, jl = getattr(tdm, which)(), getattr(jdm, which)()
        for e in (0, 1):
            tl.set_epoch(e)
            jl.set_epoch(e)
            tb, jb = list(tl), list(jl)
            assert len(tb) == len(jb) > 0
            for t, j in zip(tb, jb):
                if isinstance(j, dict):
                    assert list(t["names"]) == list(j["names"])
                    t, j = (t["hp_imgs"], t["hp_masks"]), (j["hp_imgs"], j["hp_masks"])
                for a, b in zip(t, j):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
    if depth:
        assert np.isinf(tdm.train_ds.samples[0][1]).any()  # the masked background


def test_real_datasets_and_flat_configs_raise(tmp_path, monkeypatch):
    # the real datamodules exist now: without the dataset on disk they raise, naming it
    monkeypatch.setenv("HEAL_SWIN_DATA_ROOT", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="Could not find directory"):
        tdata.get_data_module(tdc.WoodscapeHPConfig())
    # so do the flat ones, and the synthetic datamodules' writer registry names its writers
    for cfg in (tdc.WoodscapeFlatConfig(), tdc.WoodscapeDepthFlatConfig()):
        with pytest.raises(FileNotFoundError, match="Could not find directory"):
            tdata.get_data_module(cfg)
    with pytest.raises(ValueError, match="unknown writer for synthetic data"):
        tdata.get_data_module(tdc.WoodscapeHPConfig(common=tdc.WoodscapeCommonConfig(
            version="synthetic", synthetic_train_samples=1, synthetic_val_samples=1)),
        )[0].get_pred_writer("iou")
