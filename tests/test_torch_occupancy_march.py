"""The port's occupancy grid and ray march (lsenerf_tpu_torch/ops/
occupancy.py, march.py) against the JAX package: cell lookups, the
supergrid, the sampled EMA update, and march_rays on the hierarchical
branch with the packed phase-2 rule, on a jittered fresh grid and on a
sparsified one. The mask must be identical and the intervals equal to
rtol 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsenerf_tpu.cameras.rays import RayBundle as JBundle
from lsenerf_tpu.ops import march as jmarch
from lsenerf_tpu.ops import occupancy as jocc
from lsenerf_tpu_torch.cameras.rays import RayBundle as TBundle
from lsenerf_tpu_torch.ops import march as tmarch
from lsenerf_tpu_torch.ops import occupancy as tocc

import torch_parity

JG = jocc.OccGridConfig(**torch_parity.GRID)
TG = tocc.OccGridConfig(**torch_parity.GRID)


def _points(seed, n=4000):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-2.2, 2.2, (n, 3)).astype(np.float32)
    # level and cell boundaries exactly
    p[:6] = [[1.0, 0.0, 0.0], [-1.0, 0.5, 0.5], [2.0, 2.0, 2.0],
             [0.0, 0.0, 0.0], [0.0625, -0.0625, 0.5], [-2.0, 1.0, -0.5]]
    return p


def test_cell_coords_and_lookups_match():
    p = _points(0)
    occs, binaries = torch_parity.sparse_grid()
    jx, jy, jz = (jnp.asarray(p[:, i]) for i in range(3))
    tx, ty, tz = (torch.from_numpy(p[:, i]) for i in range(3))
    for a, b in zip(jocc._cell_coords(jx, jy, jz, 32, JG), tocc._cell_coords(tx, ty, tz, 32, TG)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(
        tocc._grid_lookup(torch.from_numpy(binaries), tx, ty, tz, TG).numpy(),
        np.asarray(jocc._grid_lookup(jnp.asarray(binaries), jx, jy, jz, JG)),
    )
    np.testing.assert_array_equal(
        tocc.ema_at_coords(torch.from_numpy(occs), tx, ty, tz, TG).numpy(),
        np.asarray(jocc.ema_at_coords(jnp.asarray(occs), jx, jy, jz, JG)),
    )


@pytest.mark.parametrize("factor", [8, 4])
def test_super_binaries_match(factor):
    _, binaries = torch_parity.sparse_grid(seed=1, radius=0.5)
    np.testing.assert_array_equal(
        tocc.build_super_binaries(torch.from_numpy(binaries), factor).numpy(),
        np.asarray(jocc.build_super_binaries(jnp.asarray(binaries), factor, JG)),
    )


def test_sampled_update_matches():
    key = jax.random.PRNGKey(3)
    m = 500
    cell_ids, jpos = jocc.sample_update_positions(key, JG, m)
    # the same draws the JAX function made, to rebuild its positions
    _, k2 = jax.random.split(key)
    jitter = np.array(jax.random.uniform(k2, (JG.levels, m, 3)))
    ids = np.array(cell_ids).astype(np.int64)
    np.testing.assert_array_equal(
        tocc.update_positions(torch.from_numpy(ids), torch.from_numpy(jitter), TG).numpy(),
        np.asarray(jpos),
    )
    # duplicates resolve differently (JAX: unspecified; port: the max), so
    # the update is compared on distinct cells
    ids = np.stack([np.random.default_rng(i).choice(32**3, m, replace=False) for i in range(2)])
    dens = np.random.default_rng(5).random((2, m)).astype(np.float32) * 0.05
    occs, binaries = torch_parity.sparse_grid()
    js = jocc.sampled_update(
        jocc.OccGridState(occs=jnp.asarray(occs), binaries=jnp.asarray(binaries)),
        jnp.asarray(ids, jnp.int32), jnp.asarray(dens), JG)
    ts = tocc.sampled_update(
        tocc.OccGridState(occs=torch.from_numpy(occs), binaries=torch.from_numpy(binaries)),
        torch.from_numpy(ids), torch.from_numpy(dens), TG)
    np.testing.assert_array_equal(ts.occs.numpy(), np.asarray(js.occs))
    np.testing.assert_array_equal(ts.binaries.numpy(), np.asarray(js.binaries))


def _rays(seed, n=256):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    origins = d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(1.2, 3.0, (n, 1))
    target = rng.uniform(-0.6, 0.6, (n, 3))
    dirs = target - origins
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return origins.astype(np.float32), dirs.astype(np.float32)


def _grid(kind):
    if kind == "fresh":
        u = np.array(jax.random.uniform(jax.random.PRNGKey(961103), (2, 32, 32, 32)))
        st = jocc.init_occ_grid(JG)
        tst = tocc.init_occ_grid(TG, jitter=torch.from_numpy(u))
        np.testing.assert_allclose(tst.occs.numpy(), np.asarray(st.occs), rtol=1e-6)
        return np.array(st.occs), np.array(st.binaries)
    return torch_parity.sparse_grid(seed=2, radius=0.7)


@pytest.mark.parametrize("grid", ["fresh", "sparse"])
@pytest.mark.parametrize("proposal", [8, 0])
def test_march_rays_match(grid, proposal):
    jm, tm = torch_parity.model_configs()
    jmc = dataclasses.replace(jm.march_config(), proposal_samples=proposal)
    tmc = dataclasses.replace(tm.march_config(), proposal_samples=proposal)
    assert jmc.hierarchical and jmc.packed_phase2  # the branches the port takes
    o, d = _rays(7)
    occs, binaries = _grid(grid)
    n = len(o)
    z1 = np.zeros((n, 1), np.float32)
    jb = JBundle(origins=jnp.asarray(o), directions=jnp.asarray(d),
                 pixel_area=jnp.asarray(z1), camera_indices=jnp.zeros((n, 1), jnp.int32))
    tb = TBundle(origins=torch.from_numpy(o), directions=torch.from_numpy(d),
                 pixel_area=torch.from_numpy(z1), camera_indices=torch.zeros((n, 1), dtype=torch.int32))
    js = jmarch.march_rays(
        jb, jocc.OccGridState(occs=jnp.asarray(occs), binaries=jnp.asarray(binaries)), JG, jmc)
    ts = tmarch.march_rays(
        tb, tocc.OccGridState(occs=torch.from_numpy(occs), binaries=torch.from_numpy(binaries)), TG, tmc)
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))
    np.testing.assert_allclose(ts.t_starts.numpy(), np.asarray(js.t_starts), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.t_ends.numpy(), np.asarray(js.t_ends), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.positions.numpy(), np.asarray(js.positions), rtol=1e-5, atol=1e-5)
    counts = np.asarray(js.mask).sum(1)
    if grid == "sparse":  # some rays skip everything, some keep samples
        assert (counts == 0).any() and (counts > 0).any()
