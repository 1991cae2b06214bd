"""The port's eval against the JAX package's, on the CPU: PSNR, SSIM,
LPIPS (synthetic AlexNet-shaped weights), the image helpers, the viridis
table and the Canny edges (held to matplotlib and OpenCV), the chunked
full-image render at converted JAX params, and average_eval_metrics'
eval_metrics.json / eval_mean.json with and without the events-only
rescale."""

import json
import os
import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsenerf_tpu.engine import evaluation as jeval
from lsenerf_tpu.engine import renderer as jren
from lsenerf_tpu.ops import image as jimage
from lsenerf_tpu.ops import metrics as jmetrics
from lsenerf_tpu_torch.data.imageio import read_png
from lsenerf_tpu_torch.engine import evaluation as teval
from lsenerf_tpu_torch.engine import renderer as tren
from lsenerf_tpu_torch.ops import image as timage
from lsenerf_tpu_torch.ops import metrics as tmetrics

import torch_parity
from test_lpips import make_weights


def _pair(seed, h=37, w=45, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(lo, hi, (h, w, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.1, gt.shape), lo, hi).astype(np.float32)
    return gt, pred


@pytest.mark.parametrize("seed", [0, 1])
def test_psnr_ssim_match_jax(seed):
    """Random and smooth image pairs, and a prediction outside [0, 1] (the
    mapped renderer's), to 1e-5."""
    gt, pred = _pair(seed)
    smooth = np.cumsum(np.cumsum(gt, 0), 1) / (gt.shape[0] * gt.shape[1])
    for g, p in ((gt, pred), (smooth, smooth * 0.9 + 0.05), (gt, pred * 1.3 - 0.1)):
        np.testing.assert_allclose(float(tmetrics.psnr(torch.from_numpy(g), torch.from_numpy(p))),
                                   float(jmetrics.psnr(jnp.asarray(g), jnp.asarray(p))), rtol=1e-5)
        np.testing.assert_allclose(float(tmetrics.ssim(torch.from_numpy(g), torch.from_numpy(p))),
                                   float(jmetrics.ssim(jnp.asarray(g), jnp.asarray(p))),
                                   rtol=0, atol=1e-5)


def test_lpips_matches_jax(tmp_path, monkeypatch):
    """The LPIPS forward at synthetic AlexNet-shaped weights (the .npz
    layout scripts/export_lpips.py writes), to 1e-5; without weights the
    metric is not available."""
    path = str(tmp_path / "lpips.npz")
    make_weights(path, seed=3)
    gt, pred = _pair(2, h=70, w=90)
    j = jmetrics.LPIPSMetric(path)(jnp.asarray(gt), jnp.asarray(pred))
    t = tmetrics.LPIPSMetric(path)(torch.from_numpy(gt), torch.from_numpy(pred))
    assert j > 0
    np.testing.assert_allclose(t, j, rtol=1e-5)
    monkeypatch.setenv("LSENERF_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    monkeypatch.setattr(tmetrics, "discover_lpips_weights", lambda: None)
    assert not tmetrics.LPIPSMetric().available


def test_image_helpers_match_jax():
    """correct_img_scale, linear_correction and make_error_map, to 1e-5;
    lin_log on the 0-255 grid."""
    gt, pred = _pair(4, lo=0.05, hi=0.95)
    g, p = torch.from_numpy(gt), torch.from_numpy(pred)
    jg, jp = jnp.asarray(gt), jnp.asarray(pred)
    gray_g, gray_p = g @ torch.tensor([0.2989, 0.5870, 0.1140]), p.sum(-1) / 2
    np.testing.assert_allclose(
        timage.correct_img_scale(gray_g[..., None], gray_p[..., None]).numpy(),
        np.asarray(jimage.correct_img_scale(jnp.asarray(gray_g.numpy())[..., None],
                                            jnp.asarray(gray_p.numpy())[..., None])),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(timage.linear_correction(g, p).numpy(),
                               np.asarray(jimage.linear_correction(jg, jp)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(timage.make_error_map(g, p).numpy(),
                               np.asarray(jimage.make_error_map(jg, jp)), rtol=0, atol=1e-5)
    x = np.arange(256, dtype=np.float32)
    np.testing.assert_allclose(timage.lin_log(torch.from_numpy(x)).numpy(),
                               np.asarray(jimage.lin_log(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_viridis_and_colour_maps_match_matplotlib():
    """The port's viridis table is matplotlib's, and the accumulation and
    depth maps equal the JAX package's."""
    import matplotlib

    cmap = matplotlib.colormaps["viridis"]
    np.testing.assert_array_equal(teval.VIRIDIS, cmap(np.arange(256))[:, :3])
    rng = np.random.default_rng(5)
    acc = np.concatenate([rng.uniform(-0.1, 1.1, (20, 20, 1)), np.ones((1, 20, 1))])
    np.testing.assert_array_equal(teval.apply_colormap(acc), jeval.apply_colormap(acc))
    depth = rng.uniform(0.5, 3.0, (20, 20, 1))
    np.testing.assert_array_equal(teval.apply_depth_colormap(depth, acc[:20]),
                                  jeval.apply_depth_colormap(depth, acc[:20]))


@pytest.mark.parametrize("seed", range(6))
def test_canny_equals_opencv(seed):
    """cv2.Canny(img, 50, 200) on smooth seeded images of several sizes,
    and the edge overlay the eval writes."""
    import cv2
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    h, w = rng.integers(20, 90, 2)
    img = ndimage.gaussian_filter(rng.random((h, w)) * 255, rng.uniform(0.5, 3))
    img = np.clip((img - img.min()) / (np.ptp(img) + 1e-9) * 255, 0, 255).astype(np.uint8)
    edges = cv2.Canny(img, 50, 200)
    assert edges.any()
    np.testing.assert_array_equal(teval.canny(img, 50, 200), edges)
    gt, pred = _pair(seed, h=h, w=w)
    gt = ndimage.gaussian_filter(gt, (1.5, 1.5, 0))
    np.testing.assert_array_equal(teval.make_overlay(gt, pred), jeval.make_overlay(gt, pred))


# -- the full-image render and the eval at converted JAX params ---------------


def _same_outputs(t, j, keys=("rgb", "depth", "accumulation")):
    for k in keys:
        assert t[k].shape == j[k].shape, k
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("model", [None, dict(use_mapping=False, background_color="white")],
                         ids=["mapped", "white"])
def test_render_image_matches_jax(model):
    """A 16x16 view in chunks of 100 rays (the last one short), with and
    without a pose override; mapped (the raw sum) and with the white
    background blended in."""
    jt, state, tt = torch_parity.trainers(model=model)
    cams = jt.dm.col.cameras
    c2w = np.asarray(cams.camera_to_worlds)[3].copy()
    c2w[:3, 3] += np.array([0.02, -0.01, 0.03], np.float32)
    for override in (None, c2w):
        j = jren.render_image(state.params["model"], cams, 2, state.occ, jt.model_config,
                              appearance_id=2, chunk=100, c2w_override=override)
        t = tren.render_image(tt.params["model"], tt.col_cams, 2, tt.occ, tt.model_config,
                              appearance_id=2, chunk=100, c2w_override=override)
        _same_outputs(t, {k: np.asarray(v) for k, v in j.items()})
    assert float(np.abs(t["accumulation"]).max()) > 0.1


def _perturbed_cameras(jt, state, tt, seed=6):
    """Nonzero eval-camera deltas, the same in both packages."""
    pa = np.random.default_rng(seed).normal(0, 0.01, (len(jt.dm.col.cameras), 6)).astype(np.float32)
    cam = dict(state.params["camera_opt"], col={"pose_adjustment": jnp.asarray(pa)})
    state = state.replace(params=dict(state.params, camera_opt=cam))
    with torch.no_grad():
        tt.params["camera_opt"]["col"]["pose_adjustment"].copy_(torch.from_numpy(pa))
    return state


@pytest.mark.parametrize("evs_only", [False, True], ids=["rgb", "evs_only"])
def test_average_eval_metrics_matches_jax(tmp_path, evs_only):
    """Every view of the eval split with the refined eval cameras applied:
    eval_metrics.json and eval_mean.json have the same keys, PSNR and SSIM
    within 1e-4, and the same artifact images (8-bit, within one level)."""
    jt, state, tt = torch_parity.trainers()
    state = _perturbed_cameras(jt, state, tt)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jm = jeval.average_eval_metrics(jt, state, jt.dm.col, jdir, chunk=100, apply_cam_opt=True,
                                    evs_only=evs_only)
    tm = teval.average_eval_metrics(tt, tt.dm.col, tdir, chunk=100, apply_cam_opt=True,
                                    evs_only=evs_only)
    assert set(tm) == set(jm) == {"psnr", "ssim", "num_rays_per_sec", "fps"}
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=0, atol=1e-4, err_msg=k)
    for name in ("eval_metrics.json", "eval_mean.json"):
        jd, td = (json.load(open(osp.join(d, name))) for d in (jdir, tdir))
        assert set(td) == set(jd), name
        np.testing.assert_allclose(np.asarray(td["psnr"]), np.asarray(jd["psnr"]), atol=1e-4)
        np.testing.assert_allclose(np.asarray(td["ssim"]), np.asarray(jd["ssim"]), atol=1e-4)
    jres, tres = osp.join(jdir, "eval_results"), osp.join(tdir, "eval_results")
    assert sorted(os.listdir(tres)) == sorted(os.listdir(jres))
    for key in os.listdir(jres):
        for f in sorted(os.listdir(osp.join(jres, key))):
            a = read_png(osp.join(jres, key, f)).astype(int)
            b = read_png(osp.join(tres, key, f)).astype(int)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, (key, f)
    # the mapper curves: numbers in place of the JAX package's plots
    for which in ("rgb", "evs"):
        files = os.listdir(osp.join(tdir, f"{which}_mappers"))
        assert files == [f"mapper_{which}_000.json"]
        curve = json.load(open(osp.join(tdir, f"{which}_mappers", files[0])))
        assert len(curve["x"]) == 1000 and all(len(y) == 1000 for y in curve["y"])
