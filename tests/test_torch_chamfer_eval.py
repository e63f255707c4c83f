"""heal_swin_torch's Chamfer evaluation path on the CPU against the JAX package, at
nside 16 and a small fisheye calibration: the HEALPix geometry, the camera model,
the depth point clouds and the HP cutout (integers exact, floats within 1e-12
relative to the value or, for values near 0, to the array's largest).  The HEALPix
functions are held against the JAX package as it runs, its C++ core from 2048 pixels
on (interpolation weights up to 3e-15 apart); everything downstream against the JAX
package on its numpy HEALPix path, which the port copies.  The Chamfer writer's four
metrics are held against the JAX writer with its Chamfer call routed to the Pallas
brute kernel in interpret mode (its CPU default is the expansion form), within 1e-6
relative.
"""

import numpy as np
import pytest
import torch

from heal_swin_torch.evaluation import depth_metrics_np as tdm
from heal_swin_torch.evaluation import hp_depth_pred_writers as tw
from heal_swin_torch.ops import healpix as thpx
from heal_swin_torch.projection import fisheye as tfe
from heal_swin_torch.utils import depth_utils as tdu
from heal_swin_torch.utils import image as tim
from heal_swin_tpu.data.synthetic_woodscape import make_cal_info
from heal_swin_tpu.evaluation import depth_metrics_np as jdm
from heal_swin_tpu.evaluation import hp_depth_pred_writers as jw
from heal_swin_tpu.ops import chamfer as jch
from heal_swin_tpu.ops import healpix as jhpx
from heal_swin_tpu.projection import fisheye as jfe
from heal_swin_tpu.utils import depth_utils as jdu
from heal_swin_tpu.utils import image as jim

NSIDE = 16
H, W = 80, 96
CAMS = ("FV", "RV", "MVL", "MVR")
REL = 1e-12


@pytest.fixture
def jax_numpy_healpix(monkeypatch):
    """The JAX package's HEALPix numpy path at every size, the path the port copies:
    its C++ core's interpolation weights differ from numpy's in the last bits, and
    the HP cutout tests them for equality with -1 (``mask_flat_with_hp_cutout``), so a
    few flat pixels would fall on the other side of it."""
    monkeypatch.setattr(jhpx, "_NATIVE_MIN_SIZE", 1 << 62)


def _cal(name="FV", quat=(0.0, 0.0, 0.0, 1.0)):
    cal = make_cal_info(name, W, H, min(W, H) / 2.2)
    cal["extrinsic"]["quaternion"] = list(quat)
    return cal


QUATS = [(0.0, 0.0, 0.0, 1.0), (0.1, -0.3, 0.2, 0.9)]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype.kind == want.dtype.kind
    if got.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
    else:  # relative to each value, or to the array's largest for values near 0
        scale = np.nanmax(np.abs(np.where(np.isfinite(want), want, 0)), initial=0.0)
        np.testing.assert_allclose(got, want, rtol=REL, atol=REL * scale)


@pytest.mark.parametrize("nest", [True, False])
def test_healpix_matches_jax(nest):
    npix = thpx.nside2npix(NSIDE)
    pix = np.arange(npix)
    _close(thpx.nest2ring(NSIDE, pix), jhpx.nest2ring(NSIDE, pix))
    _close(thpx.ring2nest(NSIDE, pix), jhpx.ring2nest(NSIDE, pix))
    for a, b in zip(thpx.pix2ang(NSIDE, pix, nest=nest), jhpx.pix2ang(NSIDE, pix, nest=nest)):
        _close(a, b)
    for a, b in zip(thpx.pix2vec(NSIDE, pix, nest=nest), jhpx.pix2vec(NSIDE, pix, nest=nest)):
        _close(a, b)
    rng = np.random.default_rng(0)
    theta = np.arccos(rng.uniform(-1, 1, 5000))
    phi = rng.uniform(0, 2 * np.pi, 5000)
    _close(thpx.ang2pix(NSIDE, theta, phi, nest=nest), jhpx.ang2pix(NSIDE, theta, phi, nest=nest))
    for a, b in zip(thpx.get_interp_weights(NSIDE, theta, phi, nest=nest),
                    jhpx.get_interp_weights(NSIDE, theta, phi, nest=nest)):
        _close(a, b)
    m = rng.normal(size=npix)
    _close(thpx.get_interp_val(m, theta, phi, nest=nest),
           jhpx.get_interp_val(m, theta, phi, nest=nest))
    x, y, f = thpx.nest2xyf(NSIDE, pix)
    _close(thpx.xyf2nest(NSIDE, x, y, f), pix)
    x, y, f = thpx.ring2xyf(NSIDE, pix)
    _close(thpx.xyf2ring(NSIDE, x, y, f), pix)


@pytest.mark.parametrize("quat", QUATS)
@pytest.mark.parametrize("rotate_pole", [False, True])
def test_fisheye_matches_jax(quat, rotate_pole, jax_numpy_healpix):
    cal = _cal("MVL", quat)
    theta, phi = tfe.hp_grid_angles(NSIDE, 8)
    for a, b in zip((theta, phi), jfe.hp_grid_angles(NSIDE, 8)):
        _close(a, b)
    for a, b in zip(tfe.project_s2_points_to_img(theta, phi, cal, rotate_pole),
                    jfe.project_s2_points_to_img(theta, phi, cal, rotate_pole)):
        _close(a, b)
    for res in (1.0, 40, (30, 50)):
        for a, b in zip(tfe.get_uv_from_hw(H, W, res), jfe.get_uv_from_hw(H, W, res)):
            _close(a, b)
    u, v = tfe.get_uv_from_hw(H, W, (H, W))
    for size in (None, (40, 48)):
        for a, b in zip(tfe.project_img_points_to_s2(u, v, cal, rotate_pole, size),
                        jfe.project_img_points_to_s2(u, v, cal, rotate_pole, size)):
            _close(a, b)
    hp = np.random.default_rng(1).uniform(1, 50, 8 * NSIDE * NSIDE)
    _close(tfe.project_hp_depth_back(hp, cal, 1.0, rotate_pole, NSIDE, 8, float("nan")),
           jfe.project_hp_depth_back(hp, cal, 1.0, rotate_pole, NSIDE, 8, float("nan")))
    img = np.random.default_rng(2).normal(size=(2, H, W))
    rx, ry = v.ravel()[::7] + 0.3, u.ravel()[::7] - 0.6
    _close(tfe.sample_bilinear(img, rx, ry), jfe.sample_bilinear(img, rx, ry))
    _close(tfe.rot_grid(theta, phi, cal, inv=True)[0], jfe.rot_grid(theta, phi, cal, inv=True)[0])


@pytest.mark.parametrize("size", [(40, 48), (629, 834), (80, 96)])
def test_resizes_match_jax(size):
    x = np.random.default_rng(3).normal(size=(2, H, W))
    _close(tim.resize_nearest(x, size), jim.resize_nearest(x, size))
    _close(tim.resize_bilinear(x, size), jim.resize_bilinear(x, size))
    u8 = (np.random.default_rng(4).uniform(0, 255, size=(3, H, W))).astype(np.uint8)
    _close(tim.resize_bilinear(u8, size), jim.resize_bilinear(u8, size))


def _flat_depth(seed):
    rng = np.random.default_rng(seed)
    d = rng.uniform(1, 60, size=(H, W))
    d[:10] = 1000.0  # a background band
    d[-3:, :20] = np.inf
    return d


def _hp_depth(seed):
    rng = np.random.default_rng(seed)
    d = rng.uniform(1, 60, size=8 * NSIDE * NSIDE).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.2] = np.nan
    return d


@pytest.mark.parametrize("cam", CAMS)
def test_depth_utils_and_clouds_match_jax(cam, jax_numpy_healpix):
    cal = _cal(cam, QUATS[1])
    flat, hp = _flat_depth(5)[None], _hp_depth(6)[None]
    bg = (float("nan"), float("inf"), 1000)
    _close(tdu.get_foreground_mask(flat, bg), jdu.get_foreground_mask(flat, bg))
    for data, hp_data in ((flat, False), (hp, True)):
        for a, b in zip(tdu.create_point_cloud_from_depth_mask(data, cal, NSIDE, hp_data, 8),
                        jdu.create_point_cloud_from_depth_mask(data, cal, NSIDE, hp_data, 8)):
            _close(a, b)
        for a, b in zip(tdu.get_ray_angles(data, cal, NSIDE, hp_data, 8),
                        jdu.get_ray_angles(data, cal, NSIDE, hp_data, 8)):
            _close(a, b)
    for src in (flat, tim.resize_nearest(flat, (40, 48))):
        _close(tdu.mask_flat_with_hp_cutout(src, cal, 8, NSIDE),
               jdu.mask_flat_with_hp_cutout(src, cal, 8, NSIDE))
    preds = np.random.default_rng(7).uniform(1, 60, size=(1, 1, 8 * NSIDE * NSIDE))
    hp_fg = tdu.get_foreground_mask(hp, bg)
    for kw in (dict(target=hp, hp_data=True, foreground_pix=hp_fg),
               dict(target=flat, hp_data=(True, False),
                    foreground_pix=(hp_fg, tdu.get_foreground_mask(flat, bg)))):
        for a, b in zip(tdm.build_chamfer_clouds(preds, cal_info=cal, nside=NSIDE, **kw),
                        jdm.build_chamfer_clouds(preds, cal_info=cal, nside=NSIDE, **kw)):
            _close(a, b)


def _pallas_chamfer(p, q, prepared=None):
    """The JAX package's brute Pallas kernel, interpreted, on padded clouds."""
    p = np.asarray(p, np.float32).reshape(-1, 3)
    q = np.asarray(q, np.float32).reshape(-1, 3)
    if len(p) == 0 or len(q) == 0:
        return float("nan")
    bp, bq = jch._bucket(len(p)), jch._bucket(len(q))
    pp = np.zeros((bp, 3), np.float32)
    pp[: len(p)] = p
    qp = np.zeros((bq, 3), np.float32)
    qp[: len(q)] = q
    return float(jch.chamfer_distance_masked_pallas(pp, qp, np.arange(bp) < len(p),
                                                    np.arange(bq) < len(q), interpret=True))


def _batch():
    """Two samples as the depth datamodule delivers them: HP targets standardized
    with the masked stats (background inf), metric flat targets (background 1000 /
    inf), and the model's metric-depth predictions."""
    from heal_swin_torch.data import normalize_depth_data as ndd

    stats = ndd.get_depth_data_stats(None, True)
    hp_masks, masks, preds = [], [], []
    for s in range(2):
        hp = _hp_depth(10 + s)
        hp_masks.append(np.where(np.isnan(hp), np.inf, (hp - stats.mean) / stats.std)
                        .astype(np.float32))
        masks.append(_flat_depth(20 + s))
        preds.append(np.random.default_rng(30 + s).uniform(1, 60, size=(hp.size, 1))
                     .astype(np.float32))
    batch = dict(hp_masks=np.stack(hp_masks), masks=np.stack(masks), names=["a_FV", "b_RV"],
                 cal_infos=[_cal("FV"), _cal("RV", QUATS[1])])
    return np.stack(preds), batch


WRITER_KW = dict(nside=NSIDE, base_pix=8, mask_background=True, normalize_data="standardize",
                 data_transform=None, rotate_pole=False)


def test_writer_matches_jax(monkeypatch, jax_numpy_healpix):
    small = (40, 48)
    monkeypatch.setattr(jw, "SMALL_RES", small)
    monkeypatch.setattr(tw, "SMALL_RES", small)
    monkeypatch.setattr(jdm, "_chamfer", _pallas_chamfer)
    preds, batch = _batch()
    logged = {}
    jwriter = jw.WoodscapeHPDepthChamferDistBestWorstPredictionWriter(**WRITER_KW)
    jwriter.log_metrics = lambda m: logged.update(jax=m)
    jwriter.write_on_batch_end(preds, batch, 0)
    jwriter.on_predict_epoch_end()
    writers, st = {}, []
    for route in ("brute", "pruned"):
        writers[route] = tw.WoodscapeHPDepthChamferDistBestWorstPredictionWriter(
            **WRITER_KW, device="cpu", chamfer_route=route,
            on_pair=st.append if route == "pruned" else None)
        writers[route].log_metrics = lambda m, r=route: logged.update({r: m})
        writers[route].write_on_batch_end(torch.from_numpy(preds), batch, 0)
        writers[route].on_predict_epoch_end()
    assert set(logged["brute"]) == set(logged["jax"]) == set(tw.METRICS)
    for k, want in logged["jax"].items():
        assert np.isfinite(want) and abs(logged["brute"][k] - want) <= 1e-6 * abs(want), k
        assert logged["pruned"][k] == logged["brute"][k], k  # pruned minima are exact
    assert writers["brute"].metric_values == pytest.approx(jwriter.metric_values, rel=1e-6)
    assert [list(v) for v in writers["brute"].ranked.values()] == [
        list(v) for v in jw._rank_top_bottom(jwriter.metric_values, jwriter.names, "desc", 2)
        .values()]
    assert len(st) == 8 and all(s["route"] == "pruned" and s["final_pairs"] >= 0 for s in st)
    assert [s["metric"] for s in st[:4]] == list(tw.METRICS)
    for s in st:  # the sink gets the pair's clouds and its minima in their order
        assert s["d_pq"].shape == (len(s["p"]),) and s["d_qp"].shape == (len(s["q"]),)
