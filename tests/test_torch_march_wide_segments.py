"""K3 at every march config the JAX package takes, on the CPU: segments
wider than a warp (coarse_factor > 32) and scratch past a block's shared
memory.

- The port's march_rays (K3's plain version on CPU tensors) against the
  JAX package's at coarse_factor 64, 48 (a round holds parts of two
  segments) and 33 (the packed rule off: 33**3 % 32 != 0), on one-level
  grids and on a 256^3 x 2 grid, each with and without the proposal and
  with cone_angle > 0: masks equal, the intervals within rtol 1e-5 / atol
  1e-6. Each case takes the hierarchical march, with empty and full rays.
- A numpy model of the kernel's rounds for segments wider than a warp
  (candidates end to end, 32 a round; lanes 0-3 look up the first and last
  midpoint of the round's at most two segments) gives
  packed_segment_lookup's rule, and covers every candidate once.
- `_scalars` picks the static layout, dynamic shared memory or the global
  workspace by the scratch's size; `wide_words` and the rounds agree with
  a hand count; MarchArgs keeps its earlier fields first.

The kernel itself is held to the plain version on the card
(tests/test_torch_kernels_card.py, chip_smoke.py phase 3d)."""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from lsenerf_tpu.cameras.rays import RayBundle as JBundle
from lsenerf_tpu.ops import march as jmarch
from lsenerf_tpu.ops import occupancy as jocc
from lsenerf_tpu_torch.cameras.rays import RayBundle as TBundle
from lsenerf_tpu_torch.ops import march as tmarch
from lsenerf_tpu_torch.ops import occupancy as tocc

# (grid, model): every case hierarchical, its segments wider than a warp
CASES = {
    "cf64_r128": (dict(resolution=128, levels=1), dict(coarse_factor=64, max_candidates=4096)),
    # 4096 is not a multiple of 48
    "cf48_r96": (dict(resolution=96, levels=1), dict(coarse_factor=48, max_candidates=3072)),
    "cf33_r132": (dict(resolution=132, levels=1), dict(coarse_factor=33, max_candidates=2112)),
    "cf64_r256_l2": (dict(resolution=256, levels=2), dict(coarse_factor=64, max_candidates=4096)),
}
# JAX's packed rule holds a (rays, segments, cf, cf**3 / 32) array: rays a
# call, so that it stays within 2**25 elements
JAX_ELEMENTS = 2**25


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    o = d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(1.2, 3.0, (n, 1))
    dirs = rng.uniform(-0.6, 0.6, (n, 3)) - o
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs[:6] = -dirs[:6]  # away from the grid: empty rays
    return o.astype(np.float32), dirs.astype(np.float32)


def _jax_march(o, dirs, state, gcfg, mcfg):
    """The JAX package's march_rays, op by op; with the packed rule some
    rays a call, all calls of one shape (op-by-op JAX compiles each op
    once a shape)."""
    cf, n = mcfg.coarse_factor, o.shape[0]
    per = n
    if mcfg.packed_phase2 and cf**3 % 32 == 0:
        per = JAX_ELEMENTS // (mcfg.max_coarse_segments * cf * cf**3 // 32)
        per = max(d for d in range(1, per + 1) if n % d == 0)
    outs = []
    for a in range(0, n, per):
        jb = JBundle(origins=jnp.asarray(o[a:a + per]), directions=jnp.asarray(dirs[a:a + per]),
                     pixel_area=jnp.zeros((per, 1), jnp.float32),
                     camera_indices=jnp.zeros((per, 1), jnp.int32))
        s = jmarch.march_rays(jb, state, gcfg, mcfg)
        outs.append([np.asarray(x) for x in (s.t_starts, s.t_ends, s.mask)])
    return [np.concatenate(x) for x in zip(*outs)]


@pytest.mark.parametrize("proposal", [8, 0], ids=["proposal", "no_proposal"])
@pytest.mark.parametrize("case", list(CASES))
def test_wide_segments_match_jax(case, proposal):
    grid, model = CASES[case]
    jm, tm = torch_parity.model_configs(model=dict(model, proposal_samples=proposal), grid=grid)
    jmc, tmc = jm.march_config(), tm.march_config()
    gcfg = tocc.OccGridConfig(**grid)
    assert tmarch.use_hierarchical(gcfg, tmc) and jmc.coarse_factor > 32 and tmc.cone_angle > 0
    assert tmarch.uses_proposal(tmc) == bool(proposal)
    sc = tmarch._scalars(gcfg, tmc)
    assert sc["hier"] and sc["packed"] == (case != "cf33_r132") and sc["wide"] == tmarch.STATIC
    n = 48
    o, dirs = _rays(11, n)
    occs, binaries = torch_parity.sparse_grid(seed=3, radius=0.7, **grid)
    state = tocc.OccGridState(occs=torch.from_numpy(occs), binaries=torch.from_numpy(binaries))
    tb = TBundle(origins=torch.from_numpy(o), directions=torch.from_numpy(dirs),
                 pixel_area=torch.zeros((n, 1)), camera_indices=torch.zeros((n, 1), dtype=torch.int32))
    ts = tmarch.march_rays(tb, state, gcfg, tmc)
    jstate = jocc.OccGridState(occs=jnp.asarray(occs), binaries=jnp.asarray(binaries))
    js = _jax_march(o, dirs, jstate, jocc.OccGridConfig(**grid), jmc)
    np.testing.assert_array_equal(ts.mask.numpy(), js[2])
    np.testing.assert_allclose(ts.t_starts.numpy(), js[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.t_ends.numpy(), js[1], rtol=1e-5, atol=1e-6)
    # the selection before the proposal: some rays empty, some full
    pre = tmarch.march_ts_plain(tb.origins, tb.directions, None, None, state, gcfg,
                                dataclasses.replace(tmc, proposal_samples=0))
    counts = pre[2].sum(1)
    assert (counts == 0).any() and (counts == tmc.max_samples).any()


def long_rounds_model(sup, nseg, cf):
    """The kernel's packed rule over segments wider than a warp: sup (k1,
    cf) supercells of one ray's slots, nseg kept. Returns (ends, visits):
    each candidate's rule ("in the supercell of its segment's first or last
    midpoint") and how many (round, lane) pairs took it."""
    k1 = sup.shape[0]
    flat = sup.reshape(-1)
    ends = np.zeros(k1 * cf, bool)
    visits = np.zeros(k1 * cf, int)
    for rd in range(-(-nseg * cf // 32)):
        jlo = rd * 32 // cf
        v = np.zeros(4, sup.dtype)  # lanes 0-3
        for lane in range(4):
            q = jlo + (lane >> 1)
            if q < nseg:
                v[lane] = sup[q, cf - 1 if lane & 1 else 0]
        for lane in range(32):
            c = rd * 32 + lane
            j = c // cf
            src = 2 * (j - jlo)
            assert 0 <= src <= 2
            if j < nseg:
                ends[c] = flat[c] == v[src] or flat[c] == v[src + 1]
                visits[c] += 1
    return ends, visits


@pytest.mark.parametrize("cf", [33, 48, 64, 100])
def test_long_rounds_give_the_packed_rule(cf):
    rng = np.random.default_rng(cf)
    k1 = 24
    for nseg in (0, 1, 7, k1):
        # few supercells, so that the first, the last and a third one mix
        sup = rng.integers(0, 4, (k1, cf))
        ends, visits = long_rounds_model(sup, nseg, cf)
        want = (sup == sup[:, :1]) | (sup == sup[:, -1:])  # packed_segment_lookup's in_ends
        m = nseg * cf
        assert np.array_equal(ends[:m], want.reshape(-1)[:m])
        assert (visits[:m] == 1).all() and (visits[m:] == 0).all()
        if m:
            assert want.reshape(-1)[:m].any() and not want.reshape(-1)[:m].all()


def test_wide_words_and_rounds_by_hand():
    # (hier, mc, cf, k1, k, F) -> (r1, rounds, words)
    hand = {
        (True, 64, 64, 24, 48, 16): (3, 48, 4 + 3 + 48 + 24 + 16 + 240),  # 24 x 64 / 32
        (True, 64, 48, 24, 48, 16): (3, 36, 4 + 3 + 36 + 24 + 16 + 240),  # 1152 / 32
        (True, 64, 33, 24, 16, 8): (3, 25, 4 + 3 + 25 + 24 + 8 + 80),  # ceil(792 / 32)
        (True, 128, 32, 24, 48, 0): (5, 24, 6 + 5 + 24 + 24 + 0 + 240),  # a segment a round
        (True, 128, 8, 24, 48, 16): (5, 6, 6 + 5 + 6 + 24 + 16 + 240),  # 4 segments a round
        (False, 4096, 64, 24, 3000, 16): (0, 128, 1 + 0 + 128 + 0 + 16 + 15000),
    }
    for args, want in hand.items():
        assert tmarch.wide_words(*args) == want, args


def test_scalars_pick_the_layout_by_size():
    one = tocc.OccGridConfig(resolution=128, levels=1)
    base = tmarch.MarchConfig(render_step_size=0.01, coarse_factor=64, max_candidates=4096,
                              proposal_samples=16)
    layout = lambda g, **kw: tmarch._scalars(g, dataclasses.replace(base, **kw))["wide"]  # noqa: E731
    # 24 segments of 64: 48 rounds, within the static 64
    assert layout(one) == tmarch.STATIC
    assert layout(tocc.OccGridConfig(resolution=256), max_coarse_segments=32) == tmarch.STATIC
    # 40 segments of 64: 80 rounds, past the static layout
    assert layout(one, max_coarse_segments=40) == tmarch.SHARED
    # the flat march over 4096 candidates: the global workspace from the
    # first max_samples whose block needs more than the card's shared memory
    words = lambda k: tmarch.wide_words(False, 4096, 64, 24, k, 16)[2]  # noqa: E731
    first = next(k for k in range(64, 4000) if tmarch.WARPS * 4 * words(k) > tmarch.SMEM_BYTES)
    assert 2800 < first < 3000
    flat = dict(hierarchical=False)
    assert layout(one, max_samples=first - 1, **flat) == tmarch.SHARED
    assert layout(one, max_samples=first, **flat) == tmarch.GLOBAL
    assert layout(one, max_samples=3000, **flat) == tmarch.GLOBAL
    # 12,000 slots at F = 16: 240 KB a ray of the workspace
    assert words(12_000) * 4 == 240_580 and layout(one, max_samples=12_000, **flat) == tmarch.GLOBAL


def test_march_args_keep_the_earlier_fields_first():
    """The workspace's pointer comes after the growth table and the layout
    field, so that an earlier build of csrc/march.cu reads a prefix of the
    struct."""

    class Earlier(ctypes.Structure):
        _fields_ = tmarch._MarchArgs._fields_[:-1]

    names = [f for f, _ in tmarch._MarchArgs._fields_]
    assert names[-3:] == ["growth", "wide", "scratch"]
    for f in names[:-1]:
        assert getattr(tmarch._MarchArgs, f).offset == getattr(Earlier, f).offset
