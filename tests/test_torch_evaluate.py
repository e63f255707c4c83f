"""The port's HEALPix evaluation side against the JAX package's on the CPU, on a fabricated
96 x 80 WoodScape (and SynWoodScape with depth maps; 3 images a camera) at nside 16, with
the tiny network of ``tests/test_woodscape_e2e.py`` (embed 4, window 16, depths [2, 1]),
``project_on_device`` on (the smoke configs' input path):

- (a) ``project_hp_mask_back``, ``project_hp_img_back`` and ``hp_nearest_pix_idcs`` are
  bit-equal to the JAX ones at two ``proj_res``, pole rotation on and off, but where the
  HEALPix interpolation weights of the two packages' cores differ in the last bits (the
  image at the fixture's full grid: within ``INTERP_TOL``);
- (b) the four HEALPix segmentation writers of ``get_pred_writer``, the flat HP-masked IoU
  writer and the depth ``val_on_back_projected`` writer, fed the same predictions and
  batches as their JAX twins: logged metrics within ``WRITER_TOL``, back-projected
  class maps bit-equal (depth maps within ``INTERP_TOL``), written PNGs bit-equal pixels
  (PIL reading the JAX file, the port's codec the port's);
- (c) the calibration-cluster pickles equal, each package reading the other's;
- (d) ``evaluate()`` against the JAX ``evaluate()`` on runs whose best checkpoint holds one
  set of weights (the fit's parity is ``tests/test_torch_run_entry.py``'s): the same
  metric names; the loss within ``FIT_TOL``, IoU and accuracy within ``RATE_TOL``: the
  predicted classes are the same in both packages;
- (e) ``train_model`` with ``eval_after_train=True`` logs the ``evaluate_best_*`` metrics
  and writes the base writer's PNGs;
- (f) ``python3 -m heal_swin_torch.cli evaluate`` in a subprocess.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from heal_swin_torch import evaluate as tevaluate
from heal_swin_torch import train as ttrain
from heal_swin_torch.convert import state_dict_from_flax
from heal_swin_torch.data import data as tdata
from heal_swin_torch.data import data_config as tdc
from heal_swin_torch.data.segmentation import generate_metadata as tmeta
from heal_swin_torch.data.synthetic_woodscape import generate
from heal_swin_torch.evaluation import flat_pred_writers as tfw
from heal_swin_torch.evaluation.evaluate_config import EvaluateConfig as TEvaluateConfig
from heal_swin_torch.projection import fisheye as tfe
from heal_swin_torch.tracking.mlflow_store import MlflowFileStore as TStore
from heal_swin_torch.training import checkpoint as tckpt
from heal_swin_torch.training import train_config as ttc
from heal_swin_torch.utils import overlay as tov
from heal_swin_torch.utils import png
from heal_swin_torch.utils import serialize as tser
from heal_swin_tpu import evaluate as jevaluate
from heal_swin_tpu.data import data as jdata
from heal_swin_tpu.data import data_config as jdc
from heal_swin_tpu.data.segmentation import generate_metadata as jmeta
from heal_swin_tpu.evaluation import flat_pred_writers as jfw
from heal_swin_tpu.evaluation.evaluate_config import EvaluateConfig as JEvaluateConfig
from heal_swin_tpu.models.swin_hp import SwinHPTransformerConfig
from heal_swin_tpu.models.tasks import MODEL_FROM_CONFIG_NAME, WoodscapeSegmenterSwinHPConfig
from heal_swin_tpu.projection import fisheye as jfe
from heal_swin_tpu.tracking.mlflow_store import MlflowFileStore as JStore
from heal_swin_tpu.training import checkpoint as jckpt
from heal_swin_tpu.training.train_config import PLConfig as JPLConfig
from heal_swin_tpu.training.train_config import TrainConfig as JTrainConfig
from heal_swin_tpu.utils import overlay as jov
from heal_swin_tpu.utils import serialize as jser
from tests.test_torch_trainer import FIT_TOL, to_port

NSIDE, W, H = 16, 96, 80
WRITER_TOL = 1e-12  # the writers' metrics: the same float64 numpy on the same inputs
INTERP_TOL = 1e-13  # bilinear HEALPix interpolation, relative (last-bit weight differences)
# IoU and accuracy of evaluate(): the same classes in both packages (no near-tie met on
# these weights), so only the f32 rounding of the validation means differs (5e-9 seen);
# a near-tie pixel would move a rate by 1 / 6144 or more and fail it
RATE_TOL = 1e-7
# clock readings: their names must match, their values not
CLOCKS = ("val_samples_per_sec", "predict_samples_per_sec", "predict_device_blocked_sec",
          "predict_writer_host_sec")
PL = dict(limit_val_batches=2, limit_predict_batches=2, num_sanity_val_steps=0,
          log_every_n_steps=1)
SEG_WRITERS = ("base_writer", "val_on_back_projected", "best_worst_preds",
               "back_projected_hp_masked_iou")


def common(version="woodscape", **kw):
    return dict(version=version, batch_size=1, val_batch_size=2, pred_batch_size=2,
                pred_samples=2, train_share=0.75, **kw)


def seg_data_config(dc=jdc):
    return dc.WoodscapeHPConfig(common=dc.WoodscapeCommonConfig(**common()), input_nside=NSIDE,
                                input_base_pix=8, project_on_device=True)


def depth_data_config(dc=jdc):
    return dc.WoodscapeHPDepthConfig(
        common=dc.WoodscapeCommonConfig(**common("synwoodscape")),
        common_depth=dc.WoodscapeDepthCommonConfig(mask_background=True, data_transform=None,
                                                   normalize_data="standardize"),
        input_nside=NSIDE, input_base_pix=8, project_on_device=True)


def model_config():
    return WoodscapeSegmenterSwinHPConfig(swin_hp_transformer_config=SwinHPTransformerConfig(
        patch_size=4, window_size=16, shift_size=8, shift_strategy="ring_shift", embed_dim=4,
        depths=[2, 1], num_heads=[2, 2], drop_rate=0.0, attn_drop_rate=0.0,
        drop_path_rate=0.0))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The fixtures (both versions, the npz projections made) and one set of weights."""
    root = tmp_path_factory.mktemp("evaluate")
    for version, depth in (("woodscape", False), ("synwoodscape", True)):
        generate(root / "data", version=version, n_per_cam=3, W=W, H=H, seed=0,
                 with_depth=depth)
    mp = pytest.MonkeyPatch()
    mp.setenv("HEAL_SWIN_DATA_ROOT", str(root / "data"))
    dm, spec = jdata.get_data_module(seg_data_config())
    jdata.get_data_module(depth_data_config())
    task = MODEL_FROM_CONFIG_NAME["WoodscapeSegmenterSwinHPConfig"](
        model_config(), spec, seg_data_config())
    params = task.init_variables(jax.random.PRNGKey(3), jnp.zeros((1, spec.dim_in, 3)))
    rng = np.random.default_rng(5)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape)
                          .astype(np.float32), params)
    mp.undo()
    return root, params


@pytest.fixture
def paths(world, tmp_path, monkeypatch):
    monkeypatch.setenv("HEAL_SWIN_DATA_ROOT", str(world[0] / "data"))
    monkeypatch.setenv("HEAL_SWIN_MLRUNS", str(tmp_path / "mlruns"))
    return tmp_path


class Recorder:
    """A tracking run that keeps what a writer logs."""

    def __init__(self):
        self.metrics = {}

    def log_metrics(self, metrics):
        assert not set(metrics) & set(self.metrics)
        self.metrics.update(metrics)


def close_metrics(got, want, tol=WRITER_TOL):
    assert set(got) == set(want) and got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=k)


def same_pngs(got_dir, want_dir):
    """The same file names, the port's file decoded by its codec bit-equal to the JAX
    file decoded by PIL.  Returns the file count."""
    got = sorted(p.name for p in got_dir.glob("*.png"))
    assert got and got == sorted(p.name for p in want_dir.glob("*.png"))
    for name in got:
        mine = png.read(got_dir / name)
        theirs = np.asarray(Image.open(want_dir / name))
        assert mine.color_type == 2 and mine.samples.dtype == theirs.dtype == np.uint8
        np.testing.assert_array_equal(mine.samples, theirs, err_msg=name)
    return len(got)


def fake_classes(hp_imgs, F):
    """Deterministic class maps from the images: the same predictions for both writers."""
    x = np.asarray(hp_imgs, dtype=np.int64)
    return ((x[..., 0] * 7 + x[..., 1] * 3 + x[..., 2]) % F).astype(np.int32)


@pytest.mark.parametrize("rotate_pole", [False, True])
@pytest.mark.parametrize("proj_res", [(40, 48), H])
def test_back_projection_matches_jax(world, paths, proj_res, rotate_pole):
    cals = world[0] / "data" / "woodscape" / "calibration" / "calibration"
    cal = json.loads(sorted(cals.glob("*_MVL.json"))[0].read_text())
    rng = np.random.default_rng(1)
    npix = 8 * NSIDE**2
    mask = rng.integers(0, 10, npix).astype(np.uint8)
    img = rng.uniform(0, 255, (3, npix))
    np.testing.assert_array_equal(
        tfe.project_hp_mask_back(mask, cal, proj_res, rotate_pole, NSIDE, 8, 0),
        jfe.project_hp_mask_back(mask, cal, proj_res, rotate_pole, NSIDE, 8, 0))
    got = tfe.project_hp_img_back(img, cal, proj_res, rotate_pole, 8)
    want = jfe.project_hp_img_back(img, cal, proj_res, rotate_pole, 8)
    if proj_res == H:
        # the port's numpy HEALPix core and the JAX package's C++ core give interpolation
        # weights that differ in the last bits (9e-15 at a few points of this grid)
        np.testing.assert_allclose(got, want, rtol=INTERP_TOL, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    u, v = tfe.get_uv_from_hw(H, W, proj_res)
    theta, phi = tfe.project_img_points_to_s2(u, v, cal, rotate_pole)
    got = tfe.hp_nearest_pix_idcs(theta, phi, NSIDE)
    np.testing.assert_array_equal(got, jfe.hp_nearest_pix_idcs(theta, phi, NSIDE))
    assert got is tfe.hp_nearest_pix_idcs(theta.copy(), phi.copy(), NSIDE)  # cached


def seg_modules():
    tdm, _ = tdata.get_data_module(seg_data_config(tdc))
    jdm, _ = jdata.get_data_module(seg_data_config())
    return tdm, jdm


@pytest.mark.parametrize("name,proj_res", [(n, (40, 48)) for n in SEG_WRITERS]
                         + [("back_projected_hp_masked_iou", 80),
                            ("back_projected_hp_masked_iou", H // 2)])
def test_segmentation_writers_match_jax(world, paths, name, proj_res):
    """Metrics, back-projected predictions and PNGs of each writer against its JAX twin.
    An int ``proj_res`` below the image's short side fails in both packages alike: the
    back-projection grid keeps the full width (``get_uv_from_hw``'s int branch) while
    the masks are resized to the short side, so the confusion matrix cannot pair them
    (ROADMAP queue 3 item 3)."""
    tdm, jdm = seg_modules()
    F = tdm.get_classes()
    recs, outs, flats = [], [], []
    for dm in (tdm, jdm):
        out = paths / ("port" if dm is tdm else "jax")
        out.mkdir()
        rec = Recorder()
        writer = dm.get_pred_writer(name, output_dir=out, output_resolution=0.5,
                                    proj_res=proj_res, prefix="evaluate_best_", top_k=1,
                                    ranking_metric="iou_ignored", sort_dir="asc", run=rec)
        writer.set_predict_fn(lambda imgs: fake_classes(imgs, F))
        flat = []
        batches = enumerate(tdm.predict_dataloader())
        if proj_res == H // 2:
            i, batch = next(batches)
            with pytest.raises(ValueError, match="could not be broadcast"):
                writer.write_on_batch_end(fake_classes(batch["hp_imgs"], F), batch, i)
            continue
        for i, batch in batches:
            r = writer.write_on_batch_end(fake_classes(batch["hp_imgs"], F), batch, i)
            if r is not None:
                flat.append(r[0])
        writer.on_predict_epoch_end()
        recs.append(rec.metrics)
        outs.append(out)
        flats.append(flat)
    if proj_res == H // 2:
        return
    if name in ("base_writer", "best_worst_preds"):
        assert not recs[0] and not recs[1]
        assert same_pngs(*outs) == 2  # two samples; the top and the bottom one
        return
    close_metrics(*recs)
    for a, b in zip(*flats):
        np.testing.assert_array_equal(a, b)
    suffix = "back_projected" + ("_res_40_48" if proj_res == (40, 48) else "")
    assert f"evaluate_best_val_iou_{suffix}" in recs[0]
    if name == "back_projected_hp_masked_iou":
        head = "evaluate_best_val_back_projected_hp_masked_iou" + suffix[len("back_projected"):]
        assert head in recs[0] and 0 <= recs[0][head] <= 1


def test_flat_hp_masked_iou_writer_matches_jax(world, paths):
    tdm, jdm = seg_modules()
    rng = np.random.default_rng(2)
    F = tdm.get_classes()
    kw = dict(img_dims=(H, W), f_out=F, nside=NSIDE, prefix="p_", woodscape_version="woodscape")
    writers = (tfw.WoodscapeFlatHPMaskedIoUPredictionWriter(run=Recorder(), **kw),
               jfw.WoodscapeFlatHPMaskedIoUPredictionWriter(run=Recorder(), **kw))
    for i, batch in enumerate(tdm.predict_dataloader()):
        flat = {"s2_masks": np.asarray(batch["masks"]), "names": batch["names"]}
        preds = rng.integers(0, F, flat["s2_masks"].shape)
        for w in writers:
            w.write_on_batch_end(preds, flat, i)
    for a, b in zip(writers[0].metrics.values(), writers[1].metrics.values()):
        np.testing.assert_array_equal(a.mask, b.mask)
    for w in writers:
        w.on_predict_epoch_end()
    close_metrics(writers[0].run.metrics, writers[1].run.metrics)
    assert list(writers[0].run.metrics) == ["p_val_hp_masked_iou"]  # the prefix verbatim


@pytest.mark.parametrize("proj_res", [(40, 48), 1.0])
def test_depth_val_on_back_projected_matches_jax(world, paths, proj_res):
    tdm, _ = tdata.get_data_module(depth_data_config(tdc))
    jdm, _ = jdata.get_data_module(depth_data_config())
    rng = np.random.default_rng(3)
    recs = []
    batches = list(tdm.predict_dataloader())
    preds = [rng.uniform(0.5, 40.0, (len(b["names"]), 8 * NSIDE**2, 1)).astype(np.float32)
             for b in batches]
    for dm in (tdm, jdm):
        rec = Recorder()
        w = dm.get_pred_writer("val_on_back_projected", proj_res=proj_res,
                               prefix="evaluate_best", run=rec)
        flat = [w.write_on_batch_end(p, b, i)[0] for i, (p, b) in enumerate(zip(preds, batches))]
        w.on_predict_epoch_end()
        recs.append((rec.metrics, flat))
    close_metrics(recs[0][0], recs[1][0])
    for a, b in zip(recs[0][1], recs[1][1]):
        np.testing.assert_allclose(a, b, rtol=INTERP_TOL, atol=0)
    suff = "_res_40_48" if proj_res == (40, 48) else ""
    assert set(recs[0][0]) == {f"evaluate_best_val_{k}_back_projected{suff}"
                               for k in ("mse", "SILogE", "iRMSE", "RelAE", "RelSE")}
    for name in (None, "base_writer", "best_worst_preds"):
        with pytest.raises(NotImplementedError, match="queue 1 item 8"):
            tdm.get_pred_writer(name)


def test_overlay_and_grid_match_jax(world, paths):
    tdm, _ = seg_modules()
    s = tdm.pred_dataset[0]
    got = tov.get_overlay("woodscape", s["masks"], s["imgs"], 0.7)
    np.testing.assert_array_equal(got, jov.get_overlay("woodscape", s["masks"], s["imgs"], 0.7))
    tov.save_image_grid([got, s["imgs"], got], paths / "port.png", nrow=2)
    jov.save_image_grid([got, s["imgs"], got], paths / "jax.png", nrow=2)
    np.testing.assert_array_equal(png.read(paths / "port.png").samples,
                                  np.asarray(Image.open(paths / "jax.png")))
    # an image of another size is resized to the first's, as PIL's grid does it
    tov.save_image_grid([got, got[:, :-1]], paths / "port_odd.png")
    jov.save_image_grid([got, got[:, :-1]], paths / "jax_odd.png")
    np.testing.assert_array_equal(png.read(paths / "port_odd.png").samples,
                                  np.asarray(Image.open(paths / "jax_odd.png")))


def test_cal_distribution_pickles_cross_load(world, paths):
    """Each package's pickles equal the other's, and each package's per-calibration
    writer takes the other's files as its own."""
    def written(gen, sub):
        files = {}
        for pos in ("fv", "rv", "mvl", "mvr"):
            p = paths / f"{sub}_{pos}.pickle"
            gen.get_cal_distributions(pos, p, "woodscape")
            with open(p, "rb") as f:
                files[pos] = pickle.load(f)
        return files

    mine, theirs = written(tmeta, "port"), written(jmeta, "jax")
    for pos in mine:
        assert len(mine[pos]) == len(theirs[pos]) >= 1
        for a, b in zip(mine[pos], theirs[pos]):
            assert a["cal_info"] == b["cal_info"]
            assert a["file_names"].dtype == b["file_names"].dtype
            np.testing.assert_array_equal(a["file_names"], b["file_names"])
    for gen, reader, sub in ((jmeta, tfw, "by_jax"), (tmeta, jfw, "by_port")):
        # one package writes the files, the other's writer reads them
        data = paths / sub
        (data / "woodscape").mkdir(parents=True)
        os.symlink(world[0] / "data" / "woodscape" / "calibration",
                   data / "woodscape" / "calibration")
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("HEAL_SWIN_DATA_ROOT", str(data))
            gen.gen_cal_distribution_data("woodscape")
            lists = reader.WoodscapeFlatPerCalPredictionWriter(
                woodscape_version="woodscape").sample_lists
        for pos in mine:
            assert len(lists[pos]) == len(mine[pos])
            for a, b in zip(lists[pos], mine[pos]):
                assert a["cal_info"] == b["cal_info"]
                np.testing.assert_array_equal(a["file_names"], b["file_names"])


def make_runs(world, paths):
    """A JAX run and a port run whose artifacts hold the model config and whose best
    checkpoint holds the fixture's weights: (JAX run id, port run id)."""
    _, params = world
    jstore, tstore = JStore(paths / "jmlruns"), TStore(paths / "mlruns")
    jrun, trun = jstore.create_run("eval"), tstore.create_run("eval")
    jser.save(model_config(), jrun.artifact_dir / "model_config")
    tser.save(to_port(model_config()), trun.artifact_dir / "model_config")
    for run in (jrun, trun):
        (run.artifact_dir / "checkpoints").mkdir(parents=True)
    jckpt.save_checkpoint(jrun.artifact_dir / "checkpoints" / "best.ckpt", params, {}, {})
    tckpt.save_checkpoint(trun.artifact_dir / "checkpoints" / "best.ckpt",
                          state_dict_from_flax(params), {}, {})
    return jrun.run_id, trun.run_id


def logged(run):
    return {p.name: run.get_metric_history(p.name)[-1][1]
            for p in (run.run_dir / "metrics").iterdir()}


def test_evaluate_matches_jax(world, paths, monkeypatch, capsys):
    jid, tid = make_runs(world, paths)
    kw = dict(epoch="best", pred_writer="back_projected_hp_masked_iou", proj_res=H, top_k=1,
              log_masked_iou=True)
    tevaluate.evaluate(TEvaluateConfig(path=tid, data_config=seg_data_config(tdc),
                                       **kw), ttc.PLConfig(**PL), device="cpu")
    assert "Evaluation finished." in capsys.readouterr().out
    monkeypatch.setenv("HEAL_SWIN_MLRUNS", str(paths / "jmlruns"))
    jevaluate.evaluate(JEvaluateConfig(path=jid, data_config=seg_data_config(),
                                       train_config=JTrainConfig(), **kw), JPLConfig(**PL))
    got = logged(TStore(paths / "mlruns").get_run(tid))
    want = logged(JStore(paths / "jmlruns").get_run(jid))
    assert set(got) == set(want)
    assert {"evaluate_best_val_back_projected_hp_masked_iou", "evaluate_best_val_loss",
            "evaluate_best_val_masked_iou", "evaluate_best_val_masked_iou_ignored",
            "evaluate_best_val_iou_back_projected", "evaluate_best_val_acc_back_projected",
            "evaluate_best_predict_writer_host_sec"} <= set(got)
    for name in want:
        if name.endswith(CLOCKS):
            continue
        if name.endswith("_loss"):
            np.testing.assert_allclose(got[name], want[name], err_msg=name, **FIT_TOL)
        else:
            assert 0 <= got[name] <= 1
            assert abs(got[name] - want[name]) <= RATE_TOL, name


def test_eval_after_train_evaluates(world, paths, capsys):
    """``train_model`` with ``eval_after_train=True``: the fit, then validation and the base
    writer's overlays in the same run under ``evaluate_best_``; more than one GPU still
    raises before any work."""
    _, params = world
    weights = paths / "init.ckpt"
    tckpt.save_checkpoint(weights, state_dict_from_flax(params), {}, {})
    rc = ttc.SingleModelTrainRun(
        train=ttc.TrainConfig(mlflow_expmt="entry", seed=42, eval_after_train=True,
                              load_checkpoint=str(weights)),
        data=seg_data_config(tdc), model=to_port(model_config()))
    run_id, result = ttrain.train_model(rc, ttc.PLConfig(max_epochs=1, limit_train_batches=2,
                                                         **PL), device="cpu")
    assert "Evaluation finished." in capsys.readouterr().out
    run = TStore(paths / "mlruns").get_run(run_id)
    assert run.status == "FINISHED" and result.global_step == 2
    got = logged(run)
    for name in ("evaluate_best_val_loss", "evaluate_best_val_iou_global",
                 "evaluate_best_val_acc", "evaluate_best_val_samples_per_sec",
                 "evaluate_best_predict_writer_host_sec"):
        assert np.isfinite(got[name]), name
    overlays = sorted(run.artifact_dir.glob("evaluate_best_val_*_iou=*.png"))
    assert len(overlays) == 2
    for p in overlays:
        img = png.read(p).samples
        assert img.shape == (H // 2, 2 * (W // 2), 3)
    assert (run.artifact_dir / "best").exists()  # the evaluation's config
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        ttrain.train_model(rc, ttc.PLConfig(**dict(PL, gpus=2)), device="cpu")


CONFIG_FILE = '''import os

from heal_swin_torch.data.data_config import WoodscapeCommonConfig, WoodscapeHPConfig
from heal_swin_torch.evaluation.evaluate_config import EvaluateConfig
from heal_swin_torch.training.train_config import PLConfig


def get_eval_run_config():
    return EvaluateConfig(
        path=os.environ["RUN_ID"], pred_writer="back_projected_hp_masked_iou", proj_res=(40, 48),
        top_k=1, data_config=WoodscapeHPConfig(
            common=WoodscapeCommonConfig(**{common!r}), input_nside={nside}, input_base_pix=8,
            project_on_device=True))


def get_pl_config():
    return PLConfig(**{pl!r})
'''.format(common=common(), nside=NSIDE, pl=PL)


def test_cli_evaluate(world, paths):
    _, tid = make_runs(world, paths)
    cfg = paths / "eval_config.py"
    cfg.write_text(CONFIG_FILE)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]), RUN_ID=tid)
    proc = subprocess.run([sys.executable, "-m", "heal_swin_torch.cli", "evaluate",
                           "--config_path", str(cfg), "--device", "cpu"], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Evaluation finished." in proc.stdout
    run = TStore(paths / "mlruns").get_run(tid)
    got = logged(run)
    assert 0 <= got["evaluate_best_val_back_projected_hp_masked_iou_res_40_48"] <= 1
    assert (run.artifact_dir / cfg.name).exists()
