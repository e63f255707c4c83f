"""The port's on-device projection (``heal_swin_torch/projection/device.py``) and the
datamodules' device batch transforms against the JAX package's on the CPU.

- ``DeviceProjector``: images (f32, two calibrations, per-sample ``cal_id``s) through the
  wide gather within ``IMG_TOL`` relative L2 of the JAX wide gather, and through the
  narrow plain version within ``IMG_TOL`` of the JAX narrow one; the port's wide against
  its narrow within ``IMG_TOL``; masks (uint8 and int32) and raw depth maps bit-equal.
- The cases of ``tests/test_device_projection.py``: the wide remap on grids with
  degenerate neighbours (bit-equal to the JAX remap, weights summing to the four
  bilinear weights within 1e-6), and the default ``cal_id``.
- The segmentation and depth ``device_batch_transform``s on the first validation batch
  of a 96 x 80 fixture at nside 8, against the JAX transforms on the same batch:
  segmentation images (floored) at most 1 apart and more than 99.9% equal, masks equal;
  depth images within ``IMG_TOL``, depth maps bit-equal (inf where background); and the
  segmentation transform against the on-disk npz pipeline within the bounds of
  ``tests/test_woodscape_e2e.py``'s (at most 1 apart, more than 99% equal, masks equal).
"""

import numpy as np
import pytest
import torch

from heal_swin_torch.data import data as tdata
from heal_swin_torch.data import data_config as tdc
from heal_swin_torch.data.synthetic_woodscape import generate, make_cal_info
from heal_swin_torch.projection import device as tdev
from heal_swin_torch.projection.tables import forward_table
from heal_swin_tpu.data import data as jdata
from heal_swin_tpu.data import data_config as jdc
from heal_swin_tpu.projection import device as jdev

W, H, NSIDE, BASE = 96, 80, 8, 8
IMG_TOL = 1e-6
CALS = [make_cal_info("FV", W=W, H=H, k_scale=W / 3.5),
        make_cal_info("RV", W=W, H=H, k_scale=W / 3.1)]


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def projectors():
    return tdev.DeviceProjector(CALS, NSIDE, BASE), jdev.DeviceProjector(CALS, NSIDE, BASE)


@pytest.mark.parametrize("gather", ["wide", "narrow"])
def test_images_match_jax(projectors, gather, monkeypatch):
    monkeypatch.setenv("HEAL_SWIN_PROJECT_GATHER", gather)
    tp, jp = projectors
    imgs = np.random.RandomState(0).rand(4, H, W, 3).astype(np.float32) * 255.0
    cal_ids = np.array([0, 1, 1, 0], np.int32)
    fn = tp.project_images if gather == "wide" else tp.project_images_narrow
    got = fn(torch.as_tensor(imgs), torch.as_tensor(cal_ids)).numpy()
    want = np.asarray(jp.project_images(imgs, cal_ids))
    assert got.shape == want.shape == (4, BASE * NSIDE ** 2, 3)
    assert rel_l2(got, want) <= IMG_TOL
    other = (tp.project_images_narrow if gather == "wide" else tp.project_images)(
        torch.as_tensor(imgs), torch.as_tensor(cal_ids)).numpy()
    assert rel_l2(got, other) <= IMG_TOL
    for b in range(4):  # and the host table per sample
        ref = forward_table(CALS[cal_ids[b]], NSIDE, BASE, False).apply_image(
            imgs[b].transpose(2, 0, 1))
        np.testing.assert_allclose(got[b], ref.T, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float32])
def test_masks_and_depths_match_jax(projectors, dtype):
    tp, jp = projectors
    rng = np.random.RandomState(1)
    if dtype == np.float32:  # a raw depth map: metres, 0 invalid, 1000 background
        masks = rng.choice([0.0, 1000.0, 3.25, 7.5, 40.125], size=(3, H, W)).astype(dtype)
    else:
        masks = rng.randint(0, 7, size=(3, H, W)).astype(dtype)
    cal_ids = np.array([1, 0, 1], np.int32)
    bkgd = 0 if dtype == np.float32 else 7
    got = tp.project_masks(torch.as_tensor(masks), torch.as_tensor(cal_ids), bkgd).numpy()
    want = np.asarray(jp.project_masks(masks, cal_ids, s2_bkgd_class=bkgd))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_wide_remap_covers_degenerate_neighbors():
    """Exact-integer sample coordinates make ceil == floor (degenerate neighbours
    folding onto one slot) and edge clips replicate: the remap equals the JAX one."""
    for cal in CALS:
        tab = forward_table(cal, NSIDE, BASE, rotate_pole=False)
        a, w4 = tdev._remap_wide(tab)
        ja, jw4 = jdev._remap_wide(tab)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(w4, jw4)
        W1 = tab.W + 1
        assert a.min() >= 0 and a.max() <= (tab.H + 1) * W1 - W1 - 2
        np.testing.assert_allclose(w4.sum(0), tab.w00 + tab.w10 + tab.w01 + tab.w11,
                                   rtol=0, atol=1e-6)
    # a grid of exact integer coordinates: a projector whose image is a ramp projects
    # each neighbour slot onto the right pixel
    imgs = np.arange(H * W, dtype=np.float32).reshape(1, H, W, 1).repeat(2, 0)
    proj = tdev.DeviceProjector(CALS, NSIDE, BASE)
    got = proj.project_images(torch.as_tensor(imgs), torch.tensor([0, 1]))
    want = proj.project_images_narrow(torch.as_tensor(imgs), torch.tensor([0, 1]))
    assert rel_l2(got.numpy(), want.numpy()) <= IMG_TOL


def test_default_cal_ids():
    imgs = torch.ones(2, H, W, 3)
    proj = tdev.DeviceProjector(CALS[:1], NSIDE, BASE)
    out = proj.project_images(imgs).numpy()
    tab = forward_table(CALS[0], NSIDE, BASE, rotate_pole=False)
    wsum = tab.w00 + tab.w10 + tab.w01 + tab.w11
    np.testing.assert_allclose(out[0, :, 0], wsum, rtol=1e-6, atol=1e-6)
    masks = torch.ones(2, H, W, dtype=torch.uint8)
    np.testing.assert_array_equal(proj.project_masks(masks).numpy()[1],
                                  np.where(tab.nearest_valid, 1, 0))


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("projection")
    generate(root, version="woodscape", n_per_cam=3, W=W, H=H, seed=0)
    generate(root, version="synwoodscape", n_per_cam=3, W=W, H=H, seed=0, with_depth=True)
    return root


def _config(pkg, depth, project_on_device=True):
    common = pkg.WoodscapeCommonConfig(
        version="synwoodscape" if depth else "woodscape", batch_size=2, val_batch_size=2,
        pred_batch_size=2, pred_samples=4, train_share=0.75)
    kw = dict(common=common, input_nside=NSIDE, input_base_pix=BASE,
              project_on_device=project_on_device)
    if depth:
        return pkg.WoodscapeHPDepthConfig(common_depth=pkg.WoodscapeDepthCommonConfig(
            mask_background=True, data_transform=None, normalize_data="standardize"), **kw)
    return pkg.WoodscapeHPConfig(**kw)


@pytest.mark.parametrize("depth", [False, True])
def test_device_batch_transforms_match_jax(fixture_root, depth, monkeypatch):
    monkeypatch.setenv("HEAL_SWIN_DATA_ROOT", str(fixture_root))
    tdm, _ = tdata.get_data_module(_config(tdc, depth))
    jdm, _ = jdata.get_data_module(_config(jdc, depth))
    imgs, targets = next(iter(tdm.val_dataloader()))
    got_i, got_t = tdm.device_batch_transform(
        torch.as_tensor(imgs), tuple(torch.as_tensor(t) for t in targets))
    want_i, want_t = jdm.device_batch_transform(imgs, targets)
    want_i, want_t = np.asarray(want_i), np.asarray(want_t)
    got_i, got_t = got_i.numpy(), got_t.numpy()
    assert got_i.dtype == want_i.dtype == np.float32 and got_i.shape == want_i.shape
    assert got_t.dtype == want_t.dtype
    np.testing.assert_array_equal(got_t, want_t)
    if depth:
        assert np.isinf(got_t).any() and np.isfinite(got_t).any()
        assert rel_l2(got_i, want_i) <= IMG_TOL
    else:
        assert np.abs(got_i - want_i).max() <= 1.0
        assert (got_i == want_i).mean() > 0.999
        # against the on-disk npz pipeline (test_woodscape_e2e.py's bounds)
        ndm, _ = tdata.get_data_module(_config(tdc, depth, project_on_device=False))
        npz_i, npz_t = next(iter(ndm.val_dataloader()))
        npz_i, npz_t = ndm.device_batch_transform(torch.as_tensor(npz_i),
                                                  torch.as_tensor(npz_t))
        assert np.abs(got_i - npz_i.numpy()).max() <= 1.0
        assert (got_i == npz_i.numpy()).mean() > 0.99
        np.testing.assert_array_equal(got_t, npz_t.numpy())
