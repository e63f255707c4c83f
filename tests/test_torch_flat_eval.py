"""The port's flat data and evaluation side against the JAX package's on the CPU: the
synthetic flat datamodules, the flat WoodScape datamodules on a fabricated 96 x 80 WoodScape
(and SynWoodScape with depth maps; 3 images a camera) at 32 x 64 model inputs with the HP
samples at nside 16, the flat writers, and the run and evaluation entries on a flat config
(the tiny flat network: patch 2, window 8, embed 8, depths [2, 1]; the drop rates at 0).

- (a) every dataset item and loader batch of the synthetic flat datamodules (segmentation
  and depth) and of the flat WoodScape datamodules equals the JAX one, and the uint8 wire
  format's ``device_batch_transform`` gives the JAX cast;
- (b) the flat segmentation writers of ``get_pred_writer`` (base, best/worst,
  ``val_on_hp_projected``, ``hp_masked_iou``) and the synthetic datamodules' writers, fed
  the same predictions and batches as their JAX twins: logged metrics within
  ``WRITER_TOL``, the HP-projected classes bit-equal, written PNGs bit-equal pixels (PIL
  reading the JAX file, the port's codec the port's) and npz predictions equal;
- (c) the flat depth writers: ``val_on_hp_projected`` within ``WRITER_TOL``, the Chamfer
  writer's four metrics within 1e-6 relative of the JAX writer's (both sides' minima
  exact; the JAX sums run in f32) at nside 16, brute and pruned routes equal; the writers
  that draw raise, naming ROADMAP queue 1 item 8;
- (d) ``train_model`` with ``eval_after_train`` and ``evaluate()`` with the masked IoU and
  the ``hp_masked_iou`` writer against the JAX entries from the same weights: the same
  metric names, losses within ``FIT_TOL``, rates within ``RATE_TOL``; the base writer's
  overlays bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from heal_swin_torch import evaluate as tevaluate
from heal_swin_torch import train as ttrain
from heal_swin_torch.convert import state_dict_from_flax
from heal_swin_torch.data import data as tdata
from heal_swin_torch.data import data_config as tdc
from heal_swin_torch.data.synthetic_woodscape import generate
from heal_swin_torch.evaluation import flat_depth_pred_writers as tfdw
from heal_swin_torch.evaluation import hp_depth_pred_writers as thdw
from heal_swin_torch.evaluation.evaluate_config import EvaluateConfig as TEvaluateConfig
from heal_swin_torch.tracking.mlflow_store import MlflowFileStore as TStore
from heal_swin_torch.training import checkpoint as tckpt
from heal_swin_torch.training import train_config as ttc
from heal_swin_torch.utils import png
from heal_swin_tpu import evaluate as jevaluate
from heal_swin_tpu import train as jtrain
from heal_swin_tpu.data import data as jdata
from heal_swin_tpu.data import data_config as jdc
from heal_swin_tpu.evaluation import hp_depth_pred_writers as jhdw
from heal_swin_tpu.evaluation.evaluate_config import EvaluateConfig as JEvaluateConfig
from heal_swin_tpu.models.swin_flat import SwinTransformerConfig
from heal_swin_tpu.models.tasks import MODEL_FROM_CONFIG_NAME, WoodscapeSegmenterSwinConfig
from heal_swin_tpu.ops import healpix as jhpx
from heal_swin_tpu.tracking.mlflow_store import MlflowFileStore as JStore
from heal_swin_tpu.training import checkpoint as jckpt
from heal_swin_tpu.training.train_config import PLConfig as JPLConfig
from heal_swin_tpu.training.train_config import SingleModelTrainRun, TrainConfig
from tests.test_torch_evaluate import Recorder, close_metrics, logged, same_pngs
from tests.test_torch_trainer import FIT_TOL, close_histories, history, to_port

NSIDE, W, H = 16, 96, 80  # the HP samples' nside, the fixture's image size
IN_H, IN_W = 32, 64  # the model's input size
WRITER_TOL = 1e-12
RATE_TOL = 1e-7
CLOCKS = ("val_samples_per_sec", "predict_samples_per_sec", "predict_device_blocked_sec",
          "predict_writer_host_sec", "train_time_per_sample in ms")
PL = dict(limit_val_batches=2, limit_predict_batches=2, num_sanity_val_steps=0,
          log_every_n_steps=1)
SEG_WRITERS = ("base_writer", "best_worst_preds", "val_on_hp_projected", "hp_masked_iou")


def common(version="woodscape", **kw):
    return dict(version=version, batch_size=1, val_batch_size=2, pred_batch_size=2,
                pred_samples=2, train_share=0.75, train_worker=0, val_worker=0, **kw)


def seg_data_config(dc=jdc, version="woodscape"):
    return dc.WoodscapeFlatConfig(common=dc.WoodscapeCommonConfig(**common(version)),
                                  input_width=IN_W, input_height=IN_H, nside=NSIDE, base_pix=8)


def depth_data_config(dc=jdc, version="synwoodscape"):
    return dc.WoodscapeDepthFlatConfig(
        common=dc.WoodscapeCommonConfig(**common(version)),
        common_depth=dc.WoodscapeDepthCommonConfig(mask_background=True, data_transform=None,
                                                   normalize_data="standardize"),
        input_width=IN_W, input_height=IN_H, nside=NSIDE, base_pix=8)


def model_config():
    return WoodscapeSegmenterSwinConfig(swin_transformer_config=SwinTransformerConfig(
        patch_size=2, window_size=8, shift_size=4, embed_dim=8, depths=[2, 1],
        num_heads=[2, 2], use_cos_attn=True, use_v2_norm_placement=True, drop_rate=0.0,
        attn_drop_rate=0.0, drop_path_rate=0.0))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The fixtures (both versions, the HP npz projections made) and one set of weights."""
    root = tmp_path_factory.mktemp("flat_eval")
    for version, depth in (("woodscape", False), ("synwoodscape", True)):
        generate(root / "data", version=version, n_per_cam=3, W=W, H=H, seed=0,
                 with_depth=depth)
    mp = pytest.MonkeyPatch()
    mp.setenv("HEAL_SWIN_DATA_ROOT", str(root / "data"))
    dm, spec = jdata.get_data_module(seg_data_config())
    dm.pred_dataset[0]
    jdata.get_data_module(depth_data_config())[0].pred_dataset[0]
    task = MODEL_FROM_CONFIG_NAME["WoodscapeSegmenterSwinConfig"](
        model_config(), spec, seg_data_config())
    params = task.init_variables(jax.random.PRNGKey(3), jnp.zeros((1, IN_H, IN_W, 3)))
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


def same(got, want, path="item", ulps=False):
    """Nested items / batches equal: arrays bit for bit (dtype and shape too), or with
    ``ulps`` float arrays within a few f32 ulps (5e-7 relative, 1e-7 absolute)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            same(got[k], want[k], f"{path}.{k}", ulps)
    elif isinstance(want, (list, tuple)) and not isinstance(want, str):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            same(a, b, f"{path}[{i}]", ulps)
    elif isinstance(want, (np.ndarray, jax.Array)) or isinstance(got, torch.Tensor):
        g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        w = np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype, (path, g.dtype, w.dtype)
        if ulps and g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=5e-7, atol=1e-7, err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)
    else:
        assert got == want, path


def modules(kind, version=None):
    make = seg_data_config if kind == "seg" else depth_data_config
    kw = {} if version is None else dict(version=version)
    (tdm, tspec), (jdm, jspec) = (tdata.get_data_module(make(tdc, **kw)),
                                  jdata.get_data_module(make(**kw)))
    assert spec_fields(tspec) == spec_fields(jspec)
    return tdm, jdm


def spec_fields(spec):
    """A data spec's fields, its dataset statistics by their values."""
    d = dataclasses.asdict(spec)
    if d.get("data_stats") is not None:
        d["data_stats"] = vars(d["data_stats"])
    return d


@pytest.mark.parametrize("kind", ["seg", "depth"])
def test_synthetic_flat_datamodules_match_jax(kind):
    """The depth targets go through the log transform: the JAX package takes its f32 log
    through XLA, the port through numpy, which differ in the last bit at some values
    (31 of 2048 here), so they are held within a few f32 ulps (``same``'s ``ulps``),
    everything else bit for bit."""
    ulps = kind == "depth"

    def cfg(dc):
        c = dc.WoodscapeCommonConfig(**common("synthetic", synthetic_train_samples=3,
                                              synthetic_val_samples=3))
        if kind == "seg":
            return dc.WoodscapeFlatConfig(common=c, input_width=IN_W, input_height=IN_H)
        return dc.WoodscapeDepthFlatConfig(
            common=c, input_width=IN_W, input_height=IN_H,
            common_depth=dc.WoodscapeDepthCommonConfig(mask_background=True,
                                                       data_transform="log",
                                                       normalize_data="standardize"))

    (tdm, tspec), (jdm, jspec) = tdata.get_data_module(cfg(tdc)), jdata.get_data_module(cfg(jdc))
    assert tdm.get_img_dims() == jdm.get_img_dims() == (IN_H, IN_W)
    assert spec_fields(tspec) == spec_fields(jspec)
    assert tspec.f_out == (4 if kind == "seg" else 1)
    for name in ("train_ds", "val_ds", "pred_ds"):
        a, b = getattr(tdm, name), getattr(jdm, name)
        assert len(a) == len(b) > 0
        for i in range(len(b)):
            same(a[i], b[i], f"{name}[{i}]", ulps)
    for loader in ("train_dataloader", "val_dataloader", "predict_dataloader"):
        for got, want in zip(getattr(tdm, loader)(), getattr(jdm, loader)()):
            same(got, want, loader, ulps)


@pytest.mark.parametrize("kind", ["seg", "depth"])
def test_woodscape_flat_datamodules_match_jax(world, paths, kind):
    """Every train, validation and predict item, the loaders' batches, the image sizes and
    classes, and the on-device cast of the uint8 wire format."""
    tdm, jdm = modules(kind)
    assert tdm.get_img_dims() == jdm.get_img_dims() == (IN_H, IN_W)
    assert tdm.get_classes() == jdm.get_classes()
    assert tdm.get_class_names() == jdm.get_class_names()
    for name in ("train_dataset", "val_dataset", "pred_dataset"):
        a, b = getattr(tdm, name), getattr(jdm, name)
        assert len(a) == len(b) > 0
        for i in range(len(b)):
            same(a[i], b[i], f"{name}[{i}]")
    for loader in ("train_dataloader", "val_dataloader", "predict_dataloader"):
        for got, want in zip(getattr(tdm, loader)(), getattr(jdm, loader)()):
            same(got, want, loader)
    if kind == "seg":
        imgs, masks = next(iter(tdm.train_dataloader()))
        assert imgs.dtype == masks.dtype == np.uint8 and imgs.shape[1:] == (IN_H, IN_W, 3)
        got = tdm.device_batch_transform(torch.as_tensor(imgs), torch.as_tensor(masks))
        same(got, jdm.device_batch_transform(jnp.asarray(imgs), jnp.asarray(masks)))
    else:
        assert tdm.get_original_img_dims() == jdm.get_original_img_dims() == (H, W)


def fake_classes(imgs, F):
    """Deterministic class maps from (B, H, W, 3) images: the same predictions for both
    packages' writers."""
    x = np.asarray(imgs, dtype=np.int64)
    return ((x[..., 0] * 7 + x[..., 1] * 3 + x[..., 2]) % F).astype(np.int32)


@pytest.mark.parametrize("name", SEG_WRITERS)
def test_flat_seg_writers_match_jax(world, paths, name):
    tdm, jdm = modules("seg")
    F = tdm.get_classes()
    recs, outs, projected = [], [], []
    for dm in (tdm, jdm):
        out = paths / ("port" if dm is tdm else "jax")
        out.mkdir()
        rec = Recorder()
        writer = dm.get_pred_writer(name, output_dir=out, output_resolution=0.5,
                                    prefix="evaluate_best_", top_k=1,
                                    ranking_metric="iou_ignored", sort_dir="asc", run=rec)
        writer.set_predict_fn(lambda imgs: fake_classes(imgs, F))
        hp = []
        for i, batch in enumerate(tdm.predict_dataloader()):
            r = writer.write_on_batch_end(fake_classes(batch["s2_imgs"], F), batch, i)
            if r is not None:
                hp.append(r[0])
        writer.on_predict_epoch_end()
        recs.append(rec.metrics)
        outs.append(out)
        projected.append(hp)
    if name in ("base_writer", "best_worst_preds"):
        assert not recs[0] and not recs[1]
        assert same_pngs(*outs) == 2  # two samples; the top and the bottom one
        return
    close_metrics(*recs)
    for a, b in zip(*projected):
        np.testing.assert_array_equal(a, b)
    want = {"val_on_hp_projected": "evaluate_best_val_iou_projected_to_hp",
            "hp_masked_iou": "evaluate_best_val_hp_masked_iou"}[name]
    assert want in recs[0] and 0 <= recs[0][want] <= 1


@pytest.mark.parametrize("kind", ["seg", "depth"])
def test_synthetic_writers_match_jax(paths, kind):
    from heal_swin_torch.evaluation import writers as tw
    from heal_swin_tpu.evaluation import writers as jw

    c = dict(version="synthetic", synthetic_train_samples=2, synthetic_val_samples=3,
             pred_batch_size=2, val_worker=0)
    if kind == "seg":
        cfgs = [dc.WoodscapeFlatConfig(common=dc.WoodscapeCommonConfig(**c), input_width=IN_W,
                                       input_height=IN_H) for dc in (tdc, jdc)]
    else:
        cfgs = [dc.WoodscapeDepthFlatConfig(
            common=dc.WoodscapeCommonConfig(**c), input_width=IN_W, input_height=IN_H,
            common_depth=dc.WoodscapeDepthCommonConfig(normalize_data="standardize"))
            for dc in (tdc, jdc)]
    (tdm, _), (jdm, _) = tdata.get_data_module(cfgs[0]), jdata.get_data_module(cfgs[1])
    rng = np.random.default_rng(4)
    batches = list(tdm.predict_dataloader())
    preds = [rng.integers(0, 4, b["s2_masks"].shape).astype(np.int32) if kind == "seg"
             else rng.uniform(1, 60, b["s2_masks"].shape + (1,)).astype(np.float32)
             for b in batches]
    outs, recs = [], []
    class OneByOne(Recorder):
        def log_metric(self, name, value):
            self.log_metrics({name: value})

    for dm, mod in ((tdm, tw), (jdm, jw)):
        out = paths / mod.__name__.split(".")[0]
        rec = OneByOne()
        writer = dm.get_pred_writer(None, output_dir=out, prefix="s_", run=rec)
        assert type(writer).__name__ == ("SegBasePredictionWriter" if kind == "seg"
                                         else "DepthBasePredictionWriter")
        for i, (p, b) in enumerate(zip(preds, batches)):
            writer.write_on_batch_end(p, b, i)
        writer.on_predict_epoch_end()
        outs.append(out / "predictions")
        recs.append(rec.metrics)
    close_metrics(*recs)
    names = sorted(p.name for p in outs[0].iterdir())
    assert len(names) == 3 and names == sorted(p.name for p in outs[1].iterdir())
    for n in names:
        np.testing.assert_array_equal(np.load(outs[0] / n)["pred"], np.load(outs[1] / n)["pred"])


def test_flat_depth_val_on_hp_projected_matches_jax(world, paths):
    tdm, jdm = modules("depth")
    rng = np.random.default_rng(3)
    batches = list(tdm.predict_dataloader())
    preds = [rng.uniform(0.5, 40.0, (len(b["names"]), IN_H, IN_W, 1)).astype(np.float32)
             for b in batches]
    recs = []
    for dm in (tdm, jdm):
        rec = Recorder()
        w = dm.get_pred_writer("val_on_hp_projected", prefix="evaluate_best", run=rec)
        hp = [w.write_on_batch_end(p, b, i)[0] for i, (p, b) in enumerate(zip(preds, batches))]
        w.on_predict_epoch_end()
        recs.append((rec.metrics, hp))
    close_metrics(recs[0][0], recs[1][0])
    for a, b in zip(recs[0][1], recs[1][1]):
        np.testing.assert_array_equal(a, b)
    assert set(recs[0][0]) == {f"evaluate_best_val_{k}_projected_to_hp"
                               for k in ("mse", "SILogE", "iRMSE", "RelAE", "RelSE")}
    for name in (None, "base_writer", "best_worst_preds"):
        with pytest.raises(NotImplementedError, match="queue 1 item 8"):
            tdm.get_pred_writer(name)


def test_flat_chamfer_writer_matches_jax(world, paths, monkeypatch):
    """The four Chamfer metrics of the flat writer (brute and pruned folds) against the
    JAX flat writer's, the ranking values, and each pair handed to ``on_pair``."""
    small = (40, 48)
    monkeypatch.setattr(jhdw, "SMALL_RES", small)
    monkeypatch.setattr(thdw, "SMALL_RES", small)
    monkeypatch.setattr("heal_swin_tpu.evaluation.flat_depth_pred_writers.SMALL_RES", small)
    monkeypatch.setattr(tfdw, "SMALL_RES", small)
    monkeypatch.setattr(jhpx, "_NATIVE_MIN_SIZE", 1 << 62)  # the numpy HEALPix path: see
    # tests/test_torch_chamfer_eval.py's jax_numpy_healpix
    tdm, jdm = modules("depth")
    batch = next(iter(tdm.predict_dataloader()))
    preds = np.random.default_rng(6).uniform(1, 50, (2, IN_H, IN_W, 1)).astype(np.float32)
    logged_m = {}
    jwriter = jdm.get_pred_writer("chamfer_distance", prefix="c")
    jwriter.log_metrics = lambda m: logged_m.update(jax=m)
    jwriter.write_on_batch_end(preds, batch, 0)
    jwriter.on_predict_epoch_end()
    pairs = []
    writers = {}
    for route in ("brute", "pruned"):
        w = tdm.get_pred_writer("chamfer_distance", prefix="c", device="cpu",
                                chamfer_route=route,
                                on_pair=pairs.append if route == "pruned" else None)
        w.log_metrics = lambda m, r=route: logged_m.update({r: m})
        w.write_on_batch_end(torch.from_numpy(preds), batch, 0)
        w.on_predict_epoch_end()
        writers[route] = w
    want = logged_m["jax"]
    assert set(logged_m["brute"]) == set(want) == {f"c_{k}" for k in thdw.METRICS}
    for k in want:
        assert np.isfinite(want[k]) and abs(logged_m["brute"][k] - want[k]) <= 1e-6 * abs(want[k]), k
        assert logged_m["pruned"][k] == logged_m["brute"][k], k  # pruned minima are exact
    assert writers["brute"].metric_values == pytest.approx(jwriter.metric_values, rel=1e-6)
    assert len(pairs) == 8 and [s["metric"] for s in pairs[:4]] == list(thdw.METRICS)
    assert all(s["d_pq"].shape == (len(s["p"]),) for s in pairs)


def make_runs(world, paths, eval_after_train=False):
    """A JAX run and a port run whose artifacts hold the flat model config and whose
    best checkpoint holds the fixture's weights: (JAX run id, port run id)."""
    from heal_swin_torch.utils import serialize as tser
    from heal_swin_tpu.utils import serialize as jser

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


def assert_entry_metrics(got, want):
    assert set(got) == set(want)
    for name in want:
        if name.endswith(CLOCKS):
            continue
        if name.endswith("_loss"):
            np.testing.assert_allclose(got[name], want[name], err_msg=name, **FIT_TOL)
        else:
            assert abs(got[name] - want[name]) <= RATE_TOL, name


@pytest.mark.parametrize("writer", ["hp_masked_iou", "val_on_hp_projected"])
def test_evaluate_matches_jax(world, paths, monkeypatch, writer):
    jid, tid = make_runs(world, paths)
    kw = dict(epoch="best", pred_writer=writer, top_k=1, log_masked_iou=True)
    tevaluate.evaluate(TEvaluateConfig(path=tid, data_config=seg_data_config(tdc), **kw),
                       ttc.PLConfig(**PL), device="cpu")
    monkeypatch.setenv("HEAL_SWIN_MLRUNS", str(paths / "jmlruns"))
    jevaluate.evaluate(JEvaluateConfig(path=jid, data_config=seg_data_config(),
                                       train_config=TrainConfig(), **kw), JPLConfig(**PL))
    got = logged(TStore(paths / "mlruns").get_run(tid))
    want = logged(JStore(paths / "jmlruns").get_run(jid))
    head = {"hp_masked_iou": "evaluate_best_val_hp_masked_iou",
            "val_on_hp_projected": "evaluate_best_val_iou_projected_to_hp"}[writer]
    assert {head, "evaluate_best_val_loss", "evaluate_best_val_masked_iou",
            "evaluate_best_val_iou_global"} <= set(got)
    assert_entry_metrics(got, want)


def test_train_model_with_eval_after_train_matches_jax(world, paths, capsys, monkeypatch):
    """The fit (2 epochs x 2 steps, epoch validation) and the evaluation after it, from the
    same initial weights: every logged metric, the parameter counts and the base
    writer's overlays."""
    _, params = world
    jpath, tpath = paths / "init_jax.ckpt", paths / "init_port.ckpt"
    jckpt.save_checkpoint(jpath, params, {}, {})
    tckpt.save_checkpoint(tpath, state_dict_from_flax(params), {}, {})

    def rc(weights):
        return SingleModelTrainRun(
            train=TrainConfig(mlflow_expmt="entry", seed=42, eval_after_train=True,
                              load_checkpoint=str(weights)),
            data=seg_data_config(), model=model_config())

    pl = dict(PL, max_epochs=2, limit_train_batches=2, gpus=1)
    run_id, result = ttrain.train_model(to_port(rc(tpath)), ttc.PLConfig(**pl), device="cpu")
    monkeypatch.setenv("HEAL_SWIN_MLRUNS", str(paths / "jmlruns"))
    jrun_id, _ = jtrain.train_model(rc(jpath), JPLConfig(**pl))
    assert "Evaluation finished." in capsys.readouterr().out
    run, jrun = TStore(paths / "mlruns").get_run(run_id), JStore(paths / "jmlruns").get_run(jrun_id)
    assert run.status == jrun.status == "FINISHED" and result.global_step == 4
    got = history(run)
    close_histories(got, history(jrun), FIT_TOL, skip=[n for n in got if n.endswith(CLOCKS)])
    for p in (run.run_dir / "params").iterdir():
        if p.name.startswith("total_params"):
            assert p.read_text() == (jrun.run_dir / "params" / p.name).read_text(), p.name
    assert same_pngs(run.artifact_dir, jrun.artifact_dir) == 2


def test_grid_resizes_as_pil(paths):
    """The grid's resize of an image of another size is PIL's BILINEAR bit for bit."""
    from heal_swin_torch.utils.overlay import resize_bilinear_pil, save_image_grid

    rng = np.random.default_rng(0)
    for (h, w), (H2, W2) in (((32, 64), (80, 96)), ((80, 96), (32, 64)), ((17, 33), (40, 29))):
        img = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
        want = np.asarray(Image.fromarray(img.transpose(1, 2, 0)).resize((W2, H2),
                                                                        Image.BILINEAR))
        np.testing.assert_array_equal(resize_bilinear_pil(img, (H2, W2)).transpose(1, 2, 0),
                                      want)
    first = rng.integers(0, 256, (3, 40, 29), dtype=np.uint8)
    save_image_grid([first, img], paths / "g.png")
    got = png.read(paths / "g.png").samples
    assert got.shape == (40, 58, 3)
    np.testing.assert_array_equal(got[:, 29:], want)
