"""The port's Lie-group and interpolation helpers (lsenerf_tpu_torch/ops/
lie.py, ops/interp.py) against the JAX package's, on seeded numpy inputs.
Values: rtol 1e-5, atol 1e-6; gradients (torch autograd against jax.grad):
rtol 1e-4, atol 1e-6; the host-side log map is bit-equal (both float64
numpy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from lsenerf_tpu.ops import interp as jinterp
from lsenerf_tpu.ops import lie as jlie
from lsenerf_tpu_torch.ops import interp as tinterp
from lsenerf_tpu_torch.ops import lie as tlie

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _unit(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _slerp_inputs(kind, rng, n=64):
    v0 = _unit(rng, n)
    if kind == "generic":
        v1 = _unit(rng, n)
        v1 *= np.sign((v0 * v1).sum(1, keepdims=True))  # dot >= 0
    elif kind == "dot_negative":
        v1 = _unit(rng, n)
        v1 *= -np.sign((v0 * v1).sum(1, keepdims=True))
    else:  # near: |dot| > 0.9995, on both sides of zero
        v1 = v0 + 0.004 * rng.normal(size=v0.shape).astype(np.float32)
        v1 /= np.linalg.norm(v1, axis=1, keepdims=True)
        v1[::2] *= -1
    t = rng.random((n, 1)).astype(np.float32)
    t[:8] = 0.0
    t[8:16] = 1.0
    return v0, v1.astype(np.float32), t


@pytest.mark.parametrize("kind", ["generic", "dot_negative", "near"])
def test_slerp_matches_jax(kind):
    v0, v1, t = _slerp_inputs(kind, np.random.default_rng(0))
    dots = np.abs((v0 * v1).sum(1))
    if kind == "near":
        assert dots.min() > 0.9995
    else:
        assert dots.max() < 0.9995
    if kind == "dot_negative":
        assert ((v0 * v1).sum(1) < 0).all()
    want = np.asarray(jinterp.slerp(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(t)))
    got = tinterp.slerp(_t(v0), _t(v1), _t(t)).numpy()
    np.testing.assert_allclose(got, want, **VAL)
    # t = 0 gives v0, t = 1 gives v1 up to its sign
    np.testing.assert_allclose(got[:8], v0[:8], **VAL)
    np.testing.assert_allclose(np.abs(got[8:16]), np.abs(v1[8:16]), **VAL)


def _rotations(rng, n):
    return Rotation.from_rotvec(rng.normal(size=(n, 3)) * 1.2).as_matrix()


def _poses(R, rng):
    m = np.tile(np.eye(4), (len(R), 1, 1))
    m[:, :3, :3] = R
    m[:, :3, 3] = rng.normal(size=(len(R), 3))
    return m


@pytest.mark.parametrize("kind", ["random", "near_zero", "near_pi"])
def test_matrix_to_tangent_vector_is_bit_equal(kind):
    rng = np.random.default_rng(1)
    axes = rng.normal(size=(8, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    if kind == "random":
        R = _rotations(rng, 32)
    elif kind == "near_zero":
        angles = np.array([0.0, 1e-12, 1e-9, 1e-8, 1e-7, 1e-5, 1e-3, 1e-2])
        R = Rotation.from_rotvec(axes * angles[:, None]).as_matrix()
        R[0] = np.eye(3)
    else:
        # half-turns R = 2 n n^T - I about axes led by each coordinate, and
        # angles just below pi: sin(angle) < 1e-8 takes the per-element
        # loop over the symmetric part
        axes[:3] = np.eye(3)[[2, 0, 1]] + 0.3 * axes[:3]
        axes /= np.linalg.norm(axes, axis=1, keepdims=True)
        R = np.stack([2 * np.outer(a, a) - np.eye(3) for a in axes])
        R[5:] = Rotation.from_rotvec(
            axes[5:] * (np.pi - np.array([1e-12, 1e-9, 1e-6]))[:, None]).as_matrix()
    m = _poses(R, rng)
    for mat in (m, m[:, :3, :]):  # (n, 4, 4) and (n, 3, 4)
        want = np.asarray(jlie.matrix_to_tangent_vector(mat))
        got = tlie.matrix_to_tangent_vector(mat)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    if kind == "near_pi":  # the loop's rows keep the half-turn's angle and axis
        cos = np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1)
        loop = np.abs(np.sin(np.arccos(cos))) < 1e-8
        assert loop[:5].sum() >= 3
        np.testing.assert_allclose(np.linalg.norm(got[loop, 3:], axis=1), np.pi, rtol=1e-6)
        np.testing.assert_allclose(np.abs(got[loop, 3:]) / np.pi, np.abs(axes[loop]), atol=1e-6)


def _tangents(rng, n, scale):
    tan = rng.normal(size=(n, 6)).astype(np.float32)
    tan[:, 3:] *= np.float32(scale)
    return tan


@pytest.mark.parametrize("scale", [1e-6, 1e-5, 3e-5, 0.5])
def test_exp_map_SE3_matches_jax(scale):
    """At angles below 1e-4 (squared norms below 1e-8: the series limits)
    and at a generic one; values and the gradient."""
    rng = np.random.default_rng(2)
    tan = _tangents(rng, 16, scale)
    tan[0, 3:] = 0.0
    w = rng.normal(size=(16, 3, 4)).astype(np.float32)
    want = np.asarray(jlie.exp_map_SE3(jnp.asarray(tan)))
    x = _t(tan).requires_grad_(True)
    got = tlie.exp_map_SE3(x)
    np.testing.assert_allclose(got.detach().numpy(), want, **VAL)
    (got * _t(w)).sum().backward()
    jg = jax.grad(lambda v: (jlie.exp_map_SE3(v) * w).sum())(jnp.asarray(tan))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), **GRAD)


def test_quaternion_maps_and_pose_products_match_jax():
    rng = np.random.default_rng(3)
    tan = _tangents(rng, 16, 1.0)
    pairs = [
        (jlie.exp_map_to_quat, tlie.exp_map_to_quat, tan[:, 3:]),
        (jlie.exp_map_to_quat_map, tlie.exp_map_to_quat_map, tan),
        (jlie.quat_to_rot_mat, tlie.quat_to_rot_mat, _unit(rng, 16)),
        (jlie.quat_map_to_mtx, tlie.quat_map_to_mtx,
         np.concatenate([tan[:, :3], _unit(rng, 16)], 1)),
        (jlie.to_homogeneous, tlie.to_homogeneous, rng.normal(size=(16, 3, 4)).astype(np.float32)),
    ]
    for jf, tf, x in pairs:
        np.testing.assert_allclose(tf(_t(x)).numpy(), np.asarray(jf(jnp.asarray(x))), **VAL)
    a, b = (rng.normal(size=(16, 3, 4)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(tlie.multiply_poses(_t(a), _t(b)).numpy(),
                               np.asarray(jlie.multiply_poses(jnp.asarray(a), jnp.asarray(b))), **VAL)


def test_find_closest_idxs_exclusive_matches_jax():
    """Exact matches (never returned), ties between two neighbours, and
    queries outside the range."""
    ref = np.array([0.0, 1.0, 2.0, 3.0, 5.0, 8.0, 8.5], np.float32)
    query = np.array([0.0, 2.0, 8.0, 8.5, 4.0, 1.5, 6.5, 0.4, 7.0, -1.0, 10.0, 3.0, 5.0],
                     np.float32)
    want = np.asarray(jinterp.find_closest_idxs_exclusive(jnp.asarray(ref), jnp.asarray(query)))
    got = tinterp.find_closest_idxs_exclusive(_t(ref), _t(query)).numpy()
    np.testing.assert_array_equal(got, want)
    inner = np.isin(query, ref) & (query > ref[0]) & (query < ref[-1])
    assert (ref[got[inner]] != query[inner]).all()


def _knots(rng, m=7):
    R = _rotations(rng, m)
    tan = tlie.matrix_to_tangent_vector(_poses(R, rng))
    ts = np.sort(rng.random(m) * 1e6).astype(np.float32)
    ts[0], ts[-1] = 0.0, 1e6
    return tan, ts


def test_interpolate_c2w_values_and_gradient_match_jax():
    """Query times inside, on and outside the knot range (clipped); the
    gradient with respect to the knot tangents."""
    rng = np.random.default_rng(4)
    tan, ts = _knots(rng)
    q = np.concatenate([rng.random(40) * 1e6, ts, [-5e4, -1.0, 1e6 + 1.0, 2e6]]).astype(np.float32)
    w = rng.normal(size=(len(q), 3, 4)).astype(np.float32)

    want = np.asarray(jinterp.interpolate_c2w(jnp.asarray(tan), jnp.asarray(ts), jnp.asarray(q)))
    x = _t(tan).requires_grad_(True)
    got = tinterp.interpolate_c2w(x, _t(ts), _t(q))
    np.testing.assert_allclose(got.detach().numpy(), want, **VAL)
    # outside the range the poses are the end knots'
    np.testing.assert_allclose(got[-4:-2].detach().numpy(), np.repeat(want[40:41], 2, 0), **VAL)

    (got * _t(w)).sum().backward()
    jg = jax.grad(lambda v: (jinterp.interpolate_c2w(v, jnp.asarray(ts), jnp.asarray(q)) * w).sum())(
        jnp.asarray(tan))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), **GRAD)
    assert np.abs(x.grad.numpy()).min() > 0


def test_zero_rotation_knot_gradient_is_finite():
    """The chosen divergence at an exactly-zero rotation: the JAX package's
    knot gradient through the norm is NaN there, the port's finite."""
    tan, ts = _knots(np.random.default_rng(5))
    tan[2, 3:] = 0.0
    q = np.linspace(0, 1e6, 33, dtype=np.float32)
    x = _t(tan).requires_grad_(True)
    tinterp.interpolate_c2w(x, _t(ts), _t(q)).sum().backward()
    assert np.isfinite(x.grad.numpy()).all()
    jg = jax.grad(lambda v: jinterp.interpolate_c2w(v, jnp.asarray(ts), jnp.asarray(q)).sum())(
        jnp.asarray(tan))
    assert np.isnan(np.asarray(jg)[2]).any()
    assert np.isfinite(np.delete(np.asarray(jg), 2, 0)).all()
