"""The port's last library functions against the JAX package on the CPU,
mirroring tests/test_march_composite.py's tests of them:

- the occupancy helpers (lsenerf_tpu_torch/ops/occupancy.py):
  `level_of_positions`, `occupancy_at_coords`, `occupancy_at`,
  `_cell_centers`, `full_update_positions` (fed JAX's uniform draws) and
  `full_update`, which makes a new state and leaves the old one as it was;
- `march.candidate_ts` against JAX's and against the recurrence
  t_{i+1} = t_i + max(step, cone * t_i) (rtol 2e-4, JAX's test's bound);
- `hash_encode_blocked`, the blocked layout's entry point, against JAX's
  (values and both gradients, test_torch_hash_encoding.py's tolerances).

Positions, grids and draws are made with numpy or JAX and handed to both
as numpy arrays. The cell lookups are exact (the same level and cell
arithmetic in f32), so they are held bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsenerf_tpu.ops import hash_encoding as jhe
from lsenerf_tpu.ops import march as jmarch
from lsenerf_tpu.ops import occupancy as jocc
from lsenerf_tpu_torch.ops import hash_encoding as the
from lsenerf_tpu_torch.ops import march as tmarch
from lsenerf_tpu_torch.ops import occupancy as tocc

import torch_parity

GRID = dict(resolution=16, levels=3, aabb_scale=1.5)


def _grids():
    return jocc.OccGridConfig(**GRID), tocc.OccGridConfig(**GRID)


def _states(seed=0):
    """The same random (occs, binaries) in both packages."""
    rng = np.random.default_rng(seed)
    R, L = GRID["resolution"], GRID["levels"]
    occs = rng.random((L, R, R, R)).astype(np.float32) * 0.02
    binaries = occs > 0.01
    return (jocc.OccGridState(occs=jnp.asarray(occs), binaries=jnp.asarray(binaries)),
            tocc.OccGridState(occs=torch.from_numpy(occs), binaries=torch.from_numpy(binaries)))


def _positions(n=2000, seed=1):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-7.0, 7.0, (n, 3)).astype(np.float32)
    p[:6] = [[0.5, 0, 0], [1.5, 0, 0], [1.5001, 0, 0], [3.0, -3.0, 0.2], [0, 0, 0],
             [-6.0, 0.1, 12.0]]  # level faces, the origin, past the outermost level
    return p


def test_level_of_positions_matches_jax():
    jcfg, tcfg = _grids()
    p = _positions()
    want = np.asarray(jocc.level_of_positions(jnp.asarray(p), jcfg))
    got = tocc.level_of_positions(torch.from_numpy(p), tcfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == {0, 1, 2}
    # JAX's own check: inside the base aabb level 0, outside level 1
    cfg = tocc.OccGridConfig(resolution=16, levels=2, aabb_scale=1.0)
    lv = tocc.level_of_positions(torch.tensor([[0.5, 0, 0], [1.5, 0, 0]]), cfg)
    np.testing.assert_array_equal(lv.numpy(), [0, 1])


def test_occupancy_at_matches_jax():
    jcfg, tcfg = _grids()
    js, ts = _states()
    p = _positions()
    want = np.asarray(jocc.occupancy_at(js, jnp.asarray(p), jcfg))
    got = tocc.occupancy_at(ts, torch.from_numpy(p), tcfg)
    assert got.dtype == torch.bool and got.shape == (p.shape[0],)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1
    # coordinate-separate, any common shape
    q = p[:1998].reshape(3, 666, 3)
    want = np.asarray(jocc.occupancy_at_coords(js, *(jnp.asarray(q[..., d]) for d in range(3)),
                                               jcfg))
    got = tocc.occupancy_at_coords(ts, *(torch.from_numpy(q[..., d]) for d in range(3)), tcfg)
    assert got.shape == (3, 666)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cell_centers_and_full_update_positions_match_jax():
    jcfg, tcfg = _grids()
    R, L = GRID["resolution"], GRID["levels"]
    want = np.asarray(jocc._cell_centers(jcfg))
    got = tocc._cell_centers(tcfg)
    assert got.shape == (L, R**3, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    key = jax.random.PRNGKey(4)
    u = np.array(jax.random.uniform(key, want.shape))
    want = np.asarray(jocc.full_update_positions(key, jcfg))
    got = tocc.full_update_positions(tcfg, jitter=torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # every jittered position stays in its level's aabb
    halves = GRID["aabb_scale"] * 2.0 ** np.arange(L)
    assert np.all(np.abs(got.numpy()).max(-1) <= halves[:, None])
    # from a generator: reproducible, and a different draw from another seed
    a = tocc.full_update_positions(tcfg, torch.Generator().manual_seed(0))
    b = tocc.full_update_positions(tcfg, torch.Generator().manual_seed(0))
    c = tocc.full_update_positions(tcfg, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_full_update_matches_jax_and_keeps_the_old_state():
    jcfg, tcfg = _grids()
    js, ts = _states(2)
    old = ts.occs.clone(), ts.binaries.clone()
    R, L = GRID["resolution"], GRID["levels"]
    dens = (np.random.default_rng(3).random((L, R**3)) * 0.015).astype(np.float32)
    want = jocc.full_update(js, jnp.asarray(dens), jcfg)
    got = tocc.full_update(ts, torch.from_numpy(dens), tcfg)
    assert got is not ts
    np.testing.assert_array_equal(got.occs.numpy(), np.asarray(want.occs))
    np.testing.assert_array_equal(got.binaries.numpy(), np.asarray(want.binaries))
    assert torch.equal(ts.occs, old[0]) and torch.equal(ts.binaries, old[1])


def test_full_update_binarizes_and_decays():
    """tests/test_march_composite.py's EMA check: with density only at cell
    100, 120 full updates leave it the only occupied cell; a sampled
    update then decays it once."""
    cfg = tocc.OccGridConfig(resolution=8, levels=1, aabb_scale=1.0)
    state = tocc.init_occ_grid(cfg)
    assert bool(state.binaries.all())
    dens = torch.zeros((1, 8**3))
    dens[0, 100] = 10.0
    for _ in range(120):
        state = tocc.full_update(state, dens, cfg)
    b = state.binaries.reshape(-1)
    assert b[100] and int(b.sum()) == 1
    state2 = tocc.sampled_update(state, torch.tensor([[100]]), torch.tensor([[0.0]]), cfg)
    np.testing.assert_allclose(float(state2.occs.reshape(-1)[100]), 10.0 * cfg.ema_decay, rtol=1e-5)


MARCH = dict(render_step_size=0.02, near_plane=0.05, far_plane=100.0, cone_angle=0.004,
             max_samples=32, max_candidates=256)


@pytest.mark.parametrize("cone", [0.004, 0.0])
def test_candidate_ts_matches_jax(cone):
    kw = dict(MARCH, cone_angle=cone)
    t_min = np.array([0.05, 1.7, 4.9, 5.0, 30.0], np.float32)  # t_crit = 5 at cone 0.004
    want = np.asarray(jmarch.candidate_ts(jnp.asarray(t_min), jmarch.MarchConfig(**kw)))
    got = tmarch.candidate_ts(torch.from_numpy(t_min), tmarch.MarchConfig(**kw))
    assert got.shape == (5, 257)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # the recurrence, as JAX's test holds its own
    for r, t0 in enumerate(t_min):
        t = float(t0)
        for i in range(0, 257, 8):
            np.testing.assert_allclose(float(got[r, i]), t, rtol=2e-4)
            for _ in range(8):
                t = t + max(kw["render_step_size"], cone * t)


def test_candidate_ts_zero_cone_uniform():
    cfg = tmarch.MarchConfig(render_step_size=0.1, cone_angle=0.0, max_candidates=16)
    got = tmarch.candidate_ts(torch.tensor([1.0]), cfg)[0]
    np.testing.assert_allclose(got.numpy(), 1.0 + 0.1 * np.arange(17), atol=1e-5)


@pytest.mark.parametrize("F", [2, 4])
def test_hash_encode_blocked_matches_jax(F):
    """The blocked entry point, also given a config whose layout says ngp
    (JAX's hash_encode_blocked reads the table as blocked all the same)."""
    jcfg, tcfg = torch_parity.hash_configs("float32", "blocked", features_per_level=F)
    rng = np.random.default_rng(F)
    n = 157
    pos = rng.random((n, 3)).astype(np.float32)
    table = (rng.uniform(-1, 1, tcfg.table_shape) * 1e-2).astype(np.float32)
    probe = rng.standard_normal((n, tcfg.out_dim)).astype(np.float32)
    assert int(jhe.blocked_overflow_count(jnp.asarray(pos), jcfg)) == 0

    def jloss(t, p):
        return (jhe.hash_encode_blocked(t, p, jcfg) * probe).sum()

    jout = np.asarray(jhe.hash_encode_blocked(jnp.asarray(table), jnp.asarray(pos), jcfg))
    jdt, jdp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(pos))
    for cfg in (tcfg, dataclasses.replace(tcfg, layout="ngp")):
        tt = torch.from_numpy(table).requires_grad_(True)
        tp = torch.from_numpy(pos).requires_grad_(True)
        out = the.hash_encode_blocked(tt, tp, cfg)
        (out * torch.from_numpy(probe)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jdt), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jdp), rtol=1e-4, atol=1e-5)
    # hash_encode takes the same path for the blocked layout
    np.testing.assert_array_equal(the.hash_encode(torch.from_numpy(table), torch.from_numpy(pos),
                                                  tcfg).numpy(), out.detach().numpy())
