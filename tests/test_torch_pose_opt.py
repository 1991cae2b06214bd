"""The port's camera optimizers (lsenerf_tpu_torch/cameras/pose_opt.py) and
the deblur data budget against the JAX package's: the spline's init bit
for bit, its RGB, event and deblur poses with their gradients at gate 1
and gate 0, SE3 corrections, the prev/next deltas, and one seed's batches
under deblur. Values rtol 1e-5, atol 1e-6; gradients rtol 1e-4, atol
1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from lsenerf_tpu.cameras import cameras as jcam
from lsenerf_tpu.cameras import pose_opt as jpo
from lsenerf_tpu.data import datamanager as jdm
from lsenerf_tpu.data import dataset as jds
from lsenerf_tpu.data import synthetic as jsyn
from lsenerf_tpu.engine import trainer as jtr
from lsenerf_tpu_torch.cameras import cameras as tcam
from lsenerf_tpu_torch.cameras import pose_opt as tpo
from lsenerf_tpu_torch.data import datamanager as tdm
from lsenerf_tpu_torch.data import dataset as tds
from lsenerf_tpu_torch.data import synthetic as tsyn
from lsenerf_tpu_torch.engine import trainer as ttr

import torch_parity

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
DM = np.eye(4, dtype=np.float32)
DM[:3, :3] = Rotation.from_rotvec([0.05, -0.03, 0.02]).as_matrix()
DM[:3, 3] = [0.1, -0.05, 0.02]


def _trajectory(n_cams):
    cams = jsyn.orbit_cameras(n_cams, h=16, w=16, focal=20.0)
    c2w = np.asarray(cams.camera_to_worlds)
    bottom = np.broadcast_to(np.array([[[0.0, 0, 0, 1]]], np.float32), (n_cams, 1, 4))
    return np.concatenate([c2w, bottom], 1), np.asarray(cams.times)


@pytest.mark.parametrize("factor", [1, 2])
def test_init_spline_is_bit_equal(factor):
    c2w, ts = _trajectory(6)
    jp, js = jpo.init_spline(c2w, ts, control_pnt_factor=factor, dM=DM, exp_t=20000.0)
    tp, tstat = tpo.init_spline(c2w, ts, control_pnt_factor=factor, dM=DM, exp_t=20000.0)
    assert len(js.ctrl_ts) == 5 * factor + 1
    np.testing.assert_array_equal(tp["ctrl_tangents"].numpy(), np.asarray(jp["ctrl_tangents"]))
    np.testing.assert_array_equal(tstat.ctrl_ts.numpy(), js.ctrl_ts)
    np.testing.assert_array_equal(tp["scale"].numpy(), np.asarray(jp["scale"]))
    np.testing.assert_array_equal(tstat.dM.numpy(), js.dM)
    assert (tstat.exp_t, tstat.n_deblur_rays) == (js.exp_t, js.n_deblur_rays)


def test_init_spline_on_the_flagship_scene():
    """12 knots, 1e6 / 11 apart, none at zero rotation or at pi."""
    c2w, ts = _trajectory(12)
    tp, tstat = tpo.init_spline(c2w, ts)
    np.testing.assert_allclose(np.diff(tstat.ctrl_ts.numpy()), 1e6 / 11, rtol=1e-6)
    angles = np.linalg.norm(tp["ctrl_tangents"].numpy()[:, 3:], axis=1)
    assert len(angles) == 12 and angles.min() > 0.2 and angles.max() < np.pi - 0.2


def test_init_spline_refuses_mirror_transforms():
    """Refused by scipy's Rotation where it checks the determinant, else by
    the check after its Slerp."""
    c2w, ts = _trajectory(6)
    c2w[:, :3, 0] *= -1
    with pytest.raises((AssertionError, ValueError)):
        jpo.init_spline(c2w, ts)
    with pytest.raises(ValueError):
        tpo.init_spline(c2w, ts)


def _splines(rng):
    """Both packages' spline from one trajectory, knots moved off the
    trajectory and scale 1.3, the same numbers on both sides."""
    c2w, ts = _trajectory(6)
    jp, js = jpo.init_spline(c2w, ts, dM=DM)
    tp, tstat = tpo.init_spline(c2w, ts, dM=DM)
    tan = np.asarray(jp["ctrl_tangents"]) + 0.05 * rng.normal(size=(6, 6)).astype(np.float32)
    scale = np.array([1.3], np.float32)
    jparams = {"ctrl_tangents": jnp.asarray(tan), "scale": jnp.asarray(scale)}
    tparams = {"ctrl_tangents": torch.from_numpy(tan).requires_grad_(True),
               "scale": torch.from_numpy(scale).requires_grad_(True)}
    return jparams, js, tparams, tstat


@pytest.mark.parametrize("fn", ["spline_rgb_c2w", "spline_evs_c2w", "spline_deblur_c2w"])
@pytest.mark.parametrize("gate", [1.0, 0.0])
def test_spline_poses_and_gradients_match_jax(fn, gate):
    rng = np.random.default_rng(0)
    jparams, js, tparams, tstat = _splines(rng)
    # times inside the knot range, on knots, and at the ends, where the
    # deblur poses clip to the range
    times = np.concatenate([rng.random(13) * 1e6, [0.0, 2e5, 1e6]]).astype(np.float32)
    if fn == "spline_deblur_c2w":
        times = times[:, None]
    jf, tf = getattr(jpo, fn), getattr(tpo, fn)
    want = np.asarray(jf(jparams, js, jnp.asarray(times), jnp.float32(gate)))
    got = tf(tparams, tstat, torch.from_numpy(times), gate)
    assert got.shape == want.shape == (len(times) * (4 if times.ndim == 2 else 1), 3, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, **VAL)
    # the gate gates the gradient, not the value
    np.testing.assert_allclose(
        got.detach().numpy(), tf(tparams, tstat, torch.from_numpy(times), 1.0).detach().numpy(),
        rtol=0, atol=0)

    w = rng.normal(size=want.shape).astype(np.float32)
    (got * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda p: (jf(p, js, jnp.asarray(times), jnp.float32(gate)) * w).sum())(jparams)
    for k in ("ctrl_tangents", "scale"):
        tg = tparams[k].grad
        tg = np.zeros_like(np.asarray(jg[k])) if tg is None else tg.numpy()
        np.testing.assert_allclose(tg, np.asarray(jg[k]), **GRAD, err_msg=k)
    knot_grad = tparams["ctrl_tangents"].grad.numpy()
    assert (np.abs(knot_grad).max() > 0) == (gate == 1.0)
    if fn == "spline_evs_c2w":
        assert (np.abs(tparams["scale"].grad.numpy()).max() > 0) == (gate == 1.0)


def test_spline_deblur_poses_are_time_major_per_camera():
    """A camera's 4 exposure poses are consecutive rows, at t - 15000,
    -5000, +5000, +15000, clipped to the knot range."""
    _, _, tparams, tstat = _splines(np.random.default_rng(1))
    t = torch.tensor([[4e5], [0.0]])
    got = tpo.spline_deblur_c2w(tparams, tstat, t, 1.0)
    want = tpo.spline_rgb_c2w(
        tparams, tstat, torch.tensor([385000.0, 395000, 405000, 415000, 0, 0, 5000, 15000]), 1.0)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0, atol=0)


def _bundles(n_cams=6, n=40):
    rng = np.random.default_rng(2)
    idx = rng.integers(0, n_cams, n).astype(np.int32)
    coords = np.stack([rng.integers(0, 16, n), rng.integers(0, 16, n)], 1).astype(np.float32)
    jc = jsyn.orbit_cameras(n_cams, h=16, w=16, focal=20.0)
    tc = tsyn.orbit_cameras(n_cams, h=16, w=16, focal=20.0)
    jb = jcam.generate_rays(jc, jnp.asarray(idx), jnp.asarray(coords))
    tb = tcam.generate_rays(tc, torch.from_numpy(idx), torch.from_numpy(coords))
    return jb, tb


def _deltas(rng, n_cams, scale=0.05):
    d = (scale * rng.normal(size=(n_cams, 6))).astype(np.float32)
    d[0, 3:] = 0.0  # one camera at zero rotation: SE3's series limits
    return d


@pytest.mark.parametrize("mode", ["SO3xR3", "SE3"])
def test_pose_corrections_match_jax(mode):
    rng = np.random.default_rng(3)
    d = _deltas(rng, 6)
    idx = rng.integers(0, 6, 32)
    for gate in (1.0, 0.0):
        want = jpo.pose_correction({"pose_adjustment": jnp.asarray(d)}, jnp.asarray(idx),
                                   jnp.float32(gate), mode)
        got = tpo.pose_correction({"pose_adjustment": torch.from_numpy(d)}, torch.from_numpy(idx),
                                  gate, mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)


@pytest.mark.parametrize("mode", ["SO3xR3", "SE3"])
def test_apply_prevnext_to_bundles_matches_jax(mode):
    rng = np.random.default_rng(4)
    dp, dn = _deltas(rng, 6), _deltas(rng, 6)
    jb, tb = _bundles()
    jparams = {"prev": {"pose_adjustment": jnp.asarray(dp)},
               "next": {"pose_adjustment": jnp.asarray(dn)}}
    tparams = {"prev": {"pose_adjustment": torch.from_numpy(dp).requires_grad_(True)},
               "next": {"pose_adjustment": torch.from_numpy(dn).requires_grad_(True)}}
    jprev, jnext = jpo.apply_prevnext_to_bundles(jparams, jb, jb, jnp.float32(1.0), mode)
    tprev, tnext = tpo.apply_prevnext_to_bundles(tparams, tb, tb, 1.0, mode)
    w = [rng.normal(size=(40, 3)).astype(np.float32) for _ in range(4)]
    for k, (jv, tv) in enumerate([(jprev.origins, tprev.origins), (jprev.directions, tprev.directions),
                                  (jnext.origins, tnext.origins), (jnext.directions, tnext.directions)]):
        np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), **VAL)
    # each delta set moves only its own bundle
    assert not np.allclose(np.asarray(jprev.origins), np.asarray(jnext.origins))
    loss = sum((t * torch.from_numpy(wk)).sum() for t, wk in
               zip((tprev.origins, tprev.directions, tnext.origins, tnext.directions), w))
    loss.backward()

    def jloss(p):
        a, b = jpo.apply_prevnext_to_bundles(p, jb, jb, jnp.float32(1.0), mode)
        return sum((t * wk).sum() for t, wk in zip((a.origins, a.directions, b.origins, b.directions), w))

    jg = jax.grad(jloss)(jparams)
    for sub in ("prev", "next"):
        np.testing.assert_allclose(tparams[sub]["pose_adjustment"].grad.numpy(),
                                   np.asarray(jg[sub]["pose_adjustment"]), **GRAD, err_msg=sub)
    assert tpo.apply_prevnext_to_bundles(tparams, tb, tb, 1.0, "off") == (tb, tb)


def test_deblur_budget_and_batches_match_jax():
    """The flagship budget under deblur: 3512 rays -> 579 RGB pixels (4 rays
    each) and 597 + 597 event rays; one seed gives the JAX package's
    batches."""
    jcol, jevs = jsyn.make_synthetic_scene(n_cams=12, h=64, w=64, focal=60.0)
    tcol, tevs = tsyn.make_synthetic_scene(n_cams=12, h=64, w=64, focal=60.0)
    cfg = dict(train_num_rays_per_batch=3512, rgb_frac=0.66, rgb_loss_mode="Deblur")
    jd = jdm.MultiCamDataManager(jdm.DataManagerConfig(**cfg), jcol, jevs, seed=7)
    td = tdm.MultiCamDataManager(tdm.DataManagerConfig(**cfg), tcol, tevs, seed=7)
    assert td.config.rgb_loss_mode == "deblur"
    assert (td.config.train_num_col_rays_per_batch, td.config.train_num_evs_rays_per_batch) == (579, 597)
    assert td.num_embd == jd.num_embd == 12
    for step in range(3):
        jb, tb = jd.next_train(step), td.next_train(step)
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    assert len(tb["col_indices"]) == 579 and len(tb["evs_indices"]) == 597


def test_trainer_spline_knots_from_all_cameras_match_jax():
    """The trainer places the knots on `all_cameras`, a denser trajectory
    than the train split, as the JAX trainer does; the event cameras of a
    prev/next dataset switch to the prevnext optimizer in both."""
    jm, tm = torch_parity.model_configs()
    jcol, jevs = jsyn.make_synthetic_scene(**torch_parity.SCENE)
    tcol, tevs = tsyn.make_synthetic_scene(**torch_parity.SCENE)
    jevs = torch_parity.with_prevnext(jevs, jds, jcam, jnp.asarray)
    tevs = torch_parity.with_prevnext(tevs, tds, tcam, torch.from_numpy)
    spline = dict(mode="SO3xR3", optim_type="spline", control_pnt_factor=2)
    jt = jtr.Trainer(jtr.TrainerConfig(col_cam_opt=jtr.CameraOptConfig(**spline)), jm,
                     jdm.MultiCamDataManager(jdm.DataManagerConfig(96), jcol, jevs),
                     all_cameras=jsyn.orbit_cameras(9, h=16, w=16, focal=20.0))
    tt = ttr.Trainer(ttr.TrainerConfig(col_cam_opt=ttr.CameraOptConfig(**spline)), tm,
                     tdm.MultiCamDataManager(tdm.DataManagerConfig(96), tcol, tevs), device="cpu",
                     all_cameras=tsyn.orbit_cameras(9, h=16, w=16, focal=20.0))
    assert len(tt.col_spline_static.ctrl_ts) == 17
    np.testing.assert_array_equal(tt.col_spline_params["ctrl_tangents"].numpy(),
                                  np.asarray(jt.col_spline_params["ctrl_tangents"]))
    np.testing.assert_array_equal(tt.col_spline_static.ctrl_ts.numpy(), jt.col_spline_static.ctrl_ts)
    assert tt.config.evs_cam_opt.optim_type == jt.config.evs_cam_opt.optim_type == "prevnext"
