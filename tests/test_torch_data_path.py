"""The port's real data path against the JAX package's on the CPU, bit-equal throughout, on
a 96 x 80 fixture (3 images a camera, 12 in all) at nside 8:

- the port's ``generate`` writes what the JAX ``generate`` writes: every file of both
  fixtures (WoodScape, SynWoodScape with depth maps) decodes to the same arrays through
  either package's readers, calibrations and depth maps equal;
- the HEALPix datamodules of both tasks, ``project_on_device`` on and off, with and
  without ``manual_overfit_batches``, each package on its own fixture (so each projects
  its own npz files): every item of the train, validation and predict datasets, the
  first batches of the train (two epochs), validation and predict loaders, the overfit
  indices, the image size and classes are equal;
- ``get_pred_writer``: the segmentation datamodule's four HEALPix writers, the depth
  datamodule's two that draw nothing, the drawing ones raising;
- the forward and backward projection tables equal ``heal_swin_tpu/projection/tables.py``'s
  field by field.
"""

import contextlib
import json
import os

import numpy as np
import pytest

from heal_swin_torch.data import data as tdata
from heal_swin_torch.data import data_config as tdc
from heal_swin_torch.data.synthetic_woodscape import generate as tgenerate
from heal_swin_torch.data.synthetic_woodscape import make_cal_info as t_cal
from heal_swin_torch.projection import tables as ttab
from heal_swin_torch.utils import image as TI
from heal_swin_tpu.data import data as jdata
from heal_swin_tpu.data import data_config as jdc
from heal_swin_tpu.data.synthetic_woodscape import generate as jgenerate
from heal_swin_tpu.data.synthetic_woodscape import make_cal_info as j_cal
from heal_swin_tpu.projection import tables as jtab
from heal_swin_tpu.utils import image as JI

W, H, NSIDE, N_PER_CAM = 96, 80, 8, 3
VERSIONS = (("woodscape", False), ("synwoodscape", True))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(JAX root, port root), each with both fixtures written by its own package."""
    base = tmp_path_factory.mktemp("data_path")
    for root, gen in ((base / "jax", jgenerate), (base / "port", tgenerate)):
        for version, depth in VERSIONS:
            gen(root, version=version, n_per_cam=N_PER_CAM, W=W, H=H, seed=0, with_depth=depth)
    return base / "jax", base / "port"


@contextlib.contextmanager
def data_root(path):
    old = os.environ.get("HEAL_SWIN_DATA_ROOT")
    os.environ["HEAL_SWIN_DATA_ROOT"] = str(path)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("HEAL_SWIN_DATA_ROOT")
        else:
            os.environ["HEAL_SWIN_DATA_ROOT"] = old


def same(a, b, where="item"):
    """Equal structure, dtypes and values."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("version,depth", VERSIONS)
def test_generate_matches_jax(roots, version, depth):
    jroot, troot = roots
    jfiles = sorted(p.relative_to(jroot / version) for p in (jroot / version).rglob("*"))
    tfiles = sorted(p.relative_to(troot / version) for p in (troot / version).rglob("*"))
    assert jfiles == tfiles and len(jfiles) > 4 * N_PER_CAM * (3 + depth)
    for rel in jfiles:
        j, t = jroot / version / rel, troot / version / rel
        if rel.suffix == ".png":
            for read in (JI.read_image, JI.read_mask, TI.read_image, TI.read_mask):
                same(read(t), read(j), str(rel))
        elif rel.suffix == ".json":
            assert json.loads(t.read_text()) == json.loads(j.read_text()), rel
        elif rel.suffix == ".npy":
            same(np.load(t), np.load(j), str(rel))


def _configs(pkg, depth, project_on_device, overfit):
    common = pkg.WoodscapeCommonConfig(
        version="synwoodscape" if depth else "woodscape", batch_size=2, val_batch_size=2,
        pred_batch_size=2, pred_samples=4, train_share=0.75, manual_overfit_batches=overfit)
    kw = dict(common=common, input_nside=NSIDE, input_base_pix=8,
              project_on_device=project_on_device)
    if depth:
        return pkg.WoodscapeHPDepthConfig(common_depth=pkg.WoodscapeDepthCommonConfig(
            mask_background=True, data_transform=None, normalize_data="standardize"), **kw)
    return pkg.WoodscapeHPConfig(**kw)


@pytest.mark.parametrize("overfit", [0, 1])
@pytest.mark.parametrize("project_on_device", [False, True])
@pytest.mark.parametrize("depth", [False, True])
def test_datamodules_match_jax(roots, depth, project_on_device, overfit):
    jroot, troot = roots
    with data_root(jroot):
        jdm, jspec = jdata.get_data_module(_configs(jdc, depth, project_on_device, overfit))
    with data_root(troot):
        tdm, tspec = tdata.get_data_module(_configs(tdc, depth, project_on_device, overfit))
        assert vars(tspec).keys() == vars(jspec).keys()
        for k in ("f_in", "f_out", "dim_in", "base_pix", "class_names"):
            assert getattr(tspec, k) == getattr(jspec, k), k
        for name in ("train_indices", "pred_indices"):
            same(getattr(tdm, name), getattr(jdm, name), name)
        for name in ("train_dataset", "val_dataset", "pred_dataset"):
            tds, jds = getattr(tdm, name), getattr(jdm, name)
            assert len(tds) == len(jds) > 0, name
            for i in range(len(jds)):
                same(tds[i], jds[i], f"{name}[{i}]")
        if project_on_device:
            same(tdm.train_dataset.cal_ids, jdm.train_dataset.cal_ids, "cal_ids")
            assert tdm._cal_infos == jdm._cal_infos
        for which in ("train_dataloader", "val_dataloader", "predict_dataloader"):
            tl, jl = getattr(tdm, which)(), getattr(jdm, which)()
            for epoch in (0, 1) if which == "train_dataloader" else (0,):
                tl.set_epoch(epoch)
                jl.set_epoch(epoch)
                same(next(iter(tl)), next(iter(jl)), f"{which} epoch {epoch}")


@pytest.mark.parametrize("depth", [False, True])
def test_prediction_writers(roots, depth):
    """The segmentation datamodule serves the four HEALPix writers of the JAX registry
    with the JAX datamodule's settings; the depth one its two writers that draw nothing
    (the Chamfer writer with the JAX settings), and the drawing ones raise, naming the
    item that brings them."""
    from heal_swin_torch.evaluation import hp_depth_pred_writers as TD
    from heal_swin_torch.evaluation import hp_pred_writers as TS

    with data_root(roots[1]):
        tdm, _ = tdata.get_data_module(_configs(tdc, depth, True, 0))
        if depth:
            for name in (None, "base_writer", "best_worst_preds"):
                with pytest.raises(NotImplementedError, match="queue 1 item 8"):
                    tdm.get_pred_writer(name)
            w = tdm.get_pred_writer("chamfer_distance", device="cpu")
            assert isinstance(w, TD.WoodscapeHPDepthChamferDistBestWorstPredictionWriter)
            assert (w.nside, w.base_pix, w.mask_background, w.normalize_data) == (
                NSIDE, 8, True, "standardize")
            w = tdm.get_pred_writer("val_on_back_projected")
            assert isinstance(w, TD.WoodscapeHPDepthValOnBackProjectedPredictionWriter)
            assert (w.nside, w.base_pix, w.part) == (NSIDE, 8, "val")
            return
        kinds = {None: TS.WoodscapeHPBasePredictionWriter,
                 "base_writer": TS.WoodscapeHPBasePredictionWriter,
                 "val_on_back_projected": TS.WoodscapeHPValOnBackProjectedPredictionWriter,
                 "best_worst_preds": TS.WoodscapeHPBestWorstPredictionWriter,
                 "back_projected_hp_masked_iou":
                     TS.WoodscapeHPBackProjectedHPMaskedIoUPredictionWriter}
        for name, cls in kinds.items():
            w = tdm.get_pred_writer(name, output_dir=".")
            assert type(w) is cls
            inner = getattr(w, "proj_pred_writer", w)  # the headline writer's back-projection
            assert (inner.nside, inner.base_pix, inner.rotate_pole, inner.part) == (
                NSIDE, 8, False, "val")
        assert w.f_out == inner.f_out == tdm.get_classes()
        with pytest.raises(AssertionError, match="unknown"):
            tdm.get_pred_writer("chamfer_distance")


@pytest.mark.parametrize("rotate_pole", [False, True])
def test_projection_tables_match_jax(rotate_pole):
    """Forward tables (nside 8, 4 and 16) and backward tables (two output
    resolutions) of two calibrations, every field equal."""
    for name, k_scale in (("FV", W / 3.5), ("RV", W / 3.1)):
        tc, jc = t_cal(name, W, H, k_scale), j_cal(name, W, H, k_scale)
        for nside in (4, NSIDE, 16):
            t = ttab.forward_table(tc, nside, 8, rotate_pole)
            j = jtab.forward_table(jc, nside, 8, rotate_pole)
            for f in vars(j):
                same(getattr(t, f), getattr(j, f), f"forward {f}")
        for res in (1, (40, 48)):
            t = ttab.backward_table(tc, res, NSIDE, 8, rotate_pole)
            j = jtab.backward_table(jc, res, NSIDE, 8, rotate_pole)
            for f in vars(j):
                same(getattr(t, f), getattr(j, f), f"backward {f}")
