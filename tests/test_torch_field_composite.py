"""The port's field (lsenerf_tpu_torch/models/field.py) and compositing
(ops/composite.py) against the JAX package, forward and backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsenerf_tpu.cameras.rays import RaySamples as JSamples
from lsenerf_tpu.models import field as jfield
from lsenerf_tpu.ops import composite as jcomp
from lsenerf_tpu.ops import sh as jsh
from lsenerf_tpu_torch import convert
from lsenerf_tpu_torch.cameras.rays import RaySamples as TSamples
from lsenerf_tpu_torch.engine.trainer import tree_leaves
from lsenerf_tpu_torch.models import field as tfield
from lsenerf_tpu_torch.ops import composite as tcomp
from lsenerf_tpu_torch.ops import sh as tsh

import torch_parity


def test_sh_matches():
    d = np.random.default_rng(0).standard_normal((50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    np.testing.assert_allclose(
        tsh.sh_encode(torch.from_numpy(d)).numpy(), np.asarray(jsh.sh_encode(jnp.asarray(d))),
        rtol=1e-6, atol=1e-7,
    )


def test_trunc_exp_clamps_its_gradient():
    x = torch.tensor([-20.0, 0.0, 3.0, 20.0], requires_grad=True)
    tfield.trunc_exp(x).sum().backward()
    jg = jax.grad(lambda v: jfield.trunc_exp(v).sum())(jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_field_apply_matches(dtype):
    """density and rgb, and the gradients of a probe loss with respect to
    every field parameter and the positions. The bf16 arm rounds the MLP
    inputs (forward) and their cotangents (backward) on both sides."""
    jm, tm = torch_parity.model_configs(dtype)
    jp = jfield.init_field(jax.random.PRNGKey(1), jm.field)
    rng = np.random.default_rng(2)
    n = 400
    pos = rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    pos[:4] *= 1e8  # contracted onto the cube's surface: out of bounds
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    app = rng.integers(0, 4, n).astype(np.int32)
    wd, wr = rng.standard_normal((n, 1)).astype(np.float32), rng.standard_normal((n, 3)).astype(np.float32)

    def jloss(p, x):
        d, c = jfield.field_apply(p, x, jnp.asarray(dirs), jnp.asarray(app), jm.field)
        return (d * wd).sum() + (c * wr).sum(), (d, c)

    (_, (jd, jc)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(pos))

    tp = convert.tree_to_torch(jax.tree.map(np.asarray, jp))
    leaves = dict(tree_leaves(tp))
    for t in leaves.values():
        t.requires_grad_(True)
    tx = torch.from_numpy(pos).requires_grad_(True)
    td, tc = tfield.field_apply(tp, tx, torch.from_numpy(dirs), torch.from_numpy(app), tm.field)
    ((td * torch.from_numpy(wd)).sum() + (tc * torch.from_numpy(wr)).sum()).backward()

    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-3, atol=1e-5)
    for path, g in tree_leaves(jax.tree.map(np.asarray, jgp)):
        tol = dict(rtol=1e-3, atol=1e-6)
        if path == "hash_table" and dtype == "bfloat16":
            # an f32 cotangent 1 ulp apart can round to a neighbouring bf16
            # value (2^-8 relative), so the bf16 arm's table gradient is held
            # to the bf16 tolerance of tests/test_blocked_hash.py
            tol = dict(rtol=0, atol=0.03 * np.abs(g).max())
        np.testing.assert_allclose(leaves[path].grad.numpy(), g, err_msg=path, **tol)
    # some samples lie outside the contracted cube and get zero density
    assert (np.asarray(jd) == 0).any() and (np.asarray(jd) > 0).any()


def _samples(seed, n=64, k=16):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.01, 0.2, (n, k)).astype(np.float32)
    t_ends = np.cumsum(dt, 1).astype(np.float32)
    t_starts = (t_ends - dt).astype(np.float32)
    mask = rng.random((n, k)) < 0.8
    dens = rng.exponential(3.0, (n, k, 1)).astype(np.float32)
    dens[0, 3, 0] = np.inf  # a hardened surface
    dens[1, 2, 0] = np.inf
    mask[1, 2] = False  # a masked-out inf
    rgb = rng.random((n, k, 3)).astype(np.float32)
    return t_starts, t_ends, mask, dens, rgb


@pytest.mark.parametrize("alpha_thre", [0.0, 0.01])
def test_composite_matches_with_inf_densities(alpha_thre):
    ts, te, mask, dens, rgb = _samples(3)
    n, k = mask.shape
    bg = np.random.default_rng(4).random((n, 3)).astype(np.float32)
    wr = np.random.default_rng(5).standard_normal((n, 3)).astype(np.float32)
    z3 = np.zeros((n, k, 3), np.float32)

    def jf(d, c):
        s = JSamples(positions=z3, directions=z3, t_starts=jnp.asarray(ts),
                     t_ends=jnp.asarray(te), mask=jnp.asarray(mask))
        w = jcomp.render_weights(s, d, jnp.float32(alpha_thre) if alpha_thre else 0.0, 1e-4)
        acc = jcomp.render_accumulation(w)
        out = jcomp.accumulate(w, c) + jnp.asarray(bg) * (1.0 - acc)
        return (out * wr).sum() + jcomp.render_depth(w, s).sum(), (w, out)

    (_, (jw, jout)), (jgd, jgc) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(dens), jnp.asarray(rgb))

    d = torch.from_numpy(dens).requires_grad_(True)
    c = torch.from_numpy(rgb).requires_grad_(True)
    s = TSamples(positions=torch.from_numpy(z3), directions=torch.from_numpy(z3),
                 t_starts=torch.from_numpy(ts), t_ends=torch.from_numpy(te),
                 mask=torch.from_numpy(mask))
    thre = torch.tensor(alpha_thre) if alpha_thre else 0.0
    w = tcomp.render_weights(s, d, thre, 1e-4)
    out = tcomp.render_rgb(w, c, torch.from_numpy(bg))
    ((out * torch.from_numpy(wr)).sum() + tcomp.render_depth(w, s).sum()).backward()

    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    assert np.isfinite(d.grad.numpy()).all() and np.isfinite(c.grad.numpy()).all()
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(jgd), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jgc), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("background", ["linear", "black", "white", "last_sample"])
def test_render_rgb_backgrounds_match(background):
    """render_rgb's fixed backgrounds against JAX's, values and gradients
    (last_sample blends each ray's last sample's colour)."""
    ts, te, mask, dens, rgb = _samples(6)
    dens[np.isinf(dens)] = 2.0
    z3 = np.zeros(rgb.shape, np.float32)
    wr = np.random.default_rng(7).standard_normal((mask.shape[0], 3)).astype(np.float32)

    def jf(d, c):
        s = JSamples(positions=z3, directions=z3, t_starts=jnp.asarray(ts),
                     t_ends=jnp.asarray(te), mask=jnp.asarray(mask))
        out = jcomp.render_rgb(jcomp.render_weights(s, d), c, background=background)
        return (out * wr).sum(), out

    (_, jout), (jgd, jgc) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(dens), jnp.asarray(rgb))
    d = torch.from_numpy(dens).requires_grad_(True)
    c = torch.from_numpy(rgb).requires_grad_(True)
    s = TSamples(positions=torch.from_numpy(z3), directions=torch.from_numpy(z3),
                 t_starts=torch.from_numpy(ts), t_ends=torch.from_numpy(te),
                 mask=torch.from_numpy(mask))
    out = tcomp.render_rgb(tcomp.render_weights(s, d), c, background=background)
    (out * torch.from_numpy(wr)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(jgd), rtol=1e-4, atol=1e-6)
    # the last sample's colour gets two terms, summed in another order
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jgc), rtol=1e-5, atol=1e-6)
    if background in ("white", "last_sample"):  # some rays are not opaque
        bare = tcomp.render_rgb(tcomp.render_weights(s, d), c).detach()
        assert (out.detach() - bare).abs().max() > 1e-3
