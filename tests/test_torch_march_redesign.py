"""K3's Hopper design on the CPU: the identities it rests on, held against
the plain version (march_ts_plain's pieces) and the JAX package's march.

- The growth table: t_geo_start * table[i - n_lin] is ts_at_indices' t bit
  for bit at every candidate index, for t_lo below, at and past t_crit,
  and t grows with the index (the kernel skips phase-1 rounds past t_hi).
- Phase 1's keep words: a numpy model of the kernel's ballot words (the
  occupancy word OR'd with itself shifted by one boundary and the next
  word's first bit, masked by t < t_hi and s < mc, rounds past t_hi left
  unread) equals the plain version's keep_c, and the JAX package's, on
  random grids and on the fresh all-ones grid.
- The table spans every candidate index at a max_candidates past the
  kernel's static layout (a wide launch), and a config whose scratch
  exceeds a block's shared memory takes the global workspace; the
  argument struct begins with the first design's fields in their order.
- ModelConfig keeps its train and eval march configs, the objects the
  wrapper finds its launch by.

The kernel itself is held to the plain version on the card
(tests/test_torch_kernels_card.py, chip_smoke.py phase 3d)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsenerf_tpu.ops import march as jmarch
from lsenerf_tpu.ops import occupancy as jocc
from lsenerf_tpu_torch.models.lsenerf import ModelConfig
from lsenerf_tpu_torch.ops import march as tmarch
from lsenerf_tpu_torch.ops import occupancy as tocc

# the flagship's march (lsenerf_tpu_torch/flagship.py): aabb_scale 1
FLAGSHIP = tmarch.MarchConfig(render_step_size=2 * 3**0.5 / 1000, max_candidates=1024,
                              proposal_samples=16)


@pytest.mark.parametrize("max_candidates", [1024, 512])
def test_growth_table_gives_ts_at_indices_bits(max_candidates):
    cfg = dataclasses.replace(FLAGSHIP, max_candidates=max_candidates)
    table = tmarch.growth_table(cfg.cone_angle, max_candidates, "cpu")
    assert table.shape == (max_candidates + 1,) and table.dtype == torch.float32
    step, cone = cfg.render_step_size, cfg.cone_angle
    t_crit = np.float32(step / cone)
    rng = np.random.default_rng(0)
    t_lo = np.concatenate([
        t_crit * np.array([0.0, 0.25, 0.5, 0.999], np.float32),  # below
        [t_crit, np.nextafter(t_crit, np.float32(0)), np.nextafter(t_crit, np.float32(2))],  # at
        t_crit * np.array([1.001, 1.5, 4.0, 20.0], np.float32),  # past: n_lin 0
        rng.uniform(0.0, 3.0, 64),
    ]).astype(np.float32)
    t_lo = torch.from_numpy(t_lo)
    i = torch.arange(max_candidates + 1, dtype=torch.float32)[None, :]
    want = tmarch.ts_at_indices(t_lo, i, cfg)
    # the kernel's reading: the linear stretch as before, then a table read
    n_lin = torch.ceil(torch.clamp(step / cone - t_lo, min=0.0) / step)[:, None]
    t_geo = t_lo[:, None] + n_lin * step
    g = torch.clamp(i - n_lin, min=0.0).long()
    got = torch.where(i <= n_lin, t_lo[:, None] + i * step, t_geo * table[g])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((n_lin[7:11] == 0).all()) and bool((n_lin[:3] > 0).all())
    assert (i > n_lin).float().mean() > 0.5  # most candidates read the table
    # t never falls with the index: the premise of the phase-1 skip
    assert bool((table[1:] >= table[:-1]).all()) and bool((want[:, 1:] >= want[:, :-1]).all())


def _grid(kind, gcfg, seed):
    rng = np.random.default_rng(seed)
    shape = (gcfg.levels,) + (gcfg.resolution,) * 3
    occs = rng.random(shape, dtype=np.float32)
    if kind == "ones":
        binaries = np.ones(shape, bool)
    elif kind == "random":
        binaries = rng.random(shape) < 0.2
    else:  # "sparse": 1 cell in 5000 occupied, ~10% of the 8^3 supercells
        binaries = rng.random(shape) < 2e-4
    return occs, binaries


def _rays(seed, n, far):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 1.5).astype(np.float32)
    d = (-o + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:8] = -d[:8]  # away from the grid: some miss it
    fars = rng.uniform(0.5, far, n).astype(np.float32)  # t_hi anywhere along the candidates
    return o, d, fars


def _words(bits):
    """(n, rounds * 32) bool -> (n, rounds) uint64 words, bit b = lane b."""
    n, m = bits.shape
    lanes = bits.reshape(n, m // 32, 32).astype(np.uint64)
    return (lanes << np.arange(32, dtype=np.uint64)).sum(-1, dtype=np.uint64)


def keep_words_model(tc, occ_b, t_hi, mc, step):
    """Phase 1 as K3 reads it: (n, mc) keep bits from its ballot words."""
    n, nb = tc.shape
    r1 = -(-nb // 32)
    occ = np.zeros((n, (r1 + 1) * 32), bool)
    lt = np.zeros_like(occ)
    occ[:, :nb] = occ_b
    lt[:, :nb] = tc < t_hi[:, None]
    # a round whose first boundary follows one at or past t_hi is not read
    skip = np.zeros((n, r1 + 1), bool)
    if step > 0:
        for rd in range(1, r1 + 1):
            skip[:, rd] = skip[:, rd - 1] | ~lt[:, rd * 32 - 1]
    occ &= ~np.repeat(skip, 32, axis=1)
    ow, lw = _words(occ), _words(lt)
    full = np.uint64(0xFFFFFFFF)
    keep = np.zeros((n, r1 * 32), bool)
    for rd in range(-(-mc // 32)):
        left = mc - rd * 32
        valid = full if left >= 32 else np.uint64((1 << left) - 1)
        w = (ow[:, rd] | (ow[:, rd] >> np.uint64(1)) | ((ow[:, rd + 1] << np.uint64(31)) & full))
        w &= lw[:, rd] & valid
        keep[:, rd * 32:(rd + 1) * 32] = (w[:, None] >> np.arange(32, dtype=np.uint64)) & 1 == 1
    return keep[:, :mc]


CASES = {
    "flagship_ones": (dict(), "ones"),
    "flagship_random": (dict(), "random"),
    "flagship_sparse": (dict(), "sparse"),
    "small_random": (dict(resolution=32, levels=2), "random"),
    "small_cone0": (dict(resolution=32, levels=2), "random"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_phase1_keep_words_are_keep_c(case):
    grid, kind = CASES[case]
    gcfg = tocc.OccGridConfig(**grid)
    cfg = FLAGSHIP if not grid else dataclasses.replace(FLAGSHIP, max_candidates=256)
    if case.endswith("cone0"):
        cfg = dataclasses.replace(cfg, cone_angle=0.0)
    assert tmarch.use_hierarchical(gcfg, cfg)
    seed = sorted(CASES).index(case)
    occs, binaries = _grid(kind, gcfg, seed)
    o, d, fars = _rays(seed, n=96, far=25.0)
    st = tocc.OccGridState(occs=torch.from_numpy(occs), binaries=torch.from_numpy(binaries))
    to, td, tf = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(fars)
    t_lo, t_hi = tmarch.ray_range(to, td, None, tf, gcfg, cfg)
    tc, occ_b, keep_c = tmarch._phase1(to, td, t_lo, t_hi, st, gcfg, cfg)
    mc = cfg.max_candidates // cfg.coarse_factor
    got = keep_words_model(tc.numpy(), occ_b.numpy(), t_hi.numpy(), mc, cfg.render_step_size)
    assert np.array_equal(got, keep_c.numpy())
    assert keep_c.any() and not keep_c.all()
    # the JAX package's phase 1 on the same rays and supergrid
    sup = tocc.build_super_binaries(st.binaries, cfg.coarse_factor).numpy()
    jc = jnp.arange(mc + 1, dtype=jnp.float32)[None, :] * cfg.coarse_factor
    jcfg = jmarch.MarchConfig(**dataclasses.asdict(cfg))
    jtc = jmarch.ts_at_indices(jnp.asarray(t_lo.numpy()), jc, jcfg)
    jgcfg = jocc.OccGridConfig(**dataclasses.asdict(gcfg))
    p = [jnp.asarray(o[:, c:c + 1]) + jtc * jnp.asarray(d[:, c:c + 1]) for c in range(3)]
    jocc_b = np.asarray(jocc._grid_lookup(jnp.asarray(sup), *p, jgcfg))
    jkeep = (jocc_b[:, :-1] | jocc_b[:, 1:]) & (np.asarray(jtc)[:, :-1] < t_hi.numpy()[:, None])
    assert (jkeep != keep_c.numpy()).mean() < 1e-3  # XLA's f32 pow moves some t by an ulp


def test_growth_table_spans_every_candidate_the_rounds_limit_takes():
    gcfg = tocc.OccGridConfig()
    # coarse_factor 32: twice the static layout's 64 rounds of 32 segments,
    # each 32 candidates, so the launch takes the wide layout
    big = dataclasses.replace(FLAGSHIP, coarse_factor=32,
                              max_candidates=2 * tmarch.STATIC_ROUNDS * 32 * 32)
    assert tmarch.use_hierarchical(gcfg, big)
    sc = tmarch._scalars(gcfg, big)
    assert sc["geo"] and sc["wide"] and sc["mc"] * big.coarse_factor == big.max_candidates
    table = tmarch.growth_table(big.cone_angle, big.max_candidates, "cpu")
    # the last boundary of a ray from t = 0 reads the table's last entry
    step, cone = big.render_step_size, big.cone_angle
    t_lo = torch.zeros(1)
    i = torch.tensor([[0.0, big.max_candidates / 2, big.max_candidates]])
    want = tmarch.ts_at_indices(t_lo, i, big)
    n_lin = torch.ceil(torch.clamp(step / cone - t_lo, min=0.0) / step)[:, None]
    g = torch.clamp(i - n_lin, min=0.0).long()
    got = torch.where(i <= n_lin, t_lo[:, None] + i * step, (t_lo[:, None] + n_lin * step) * table[g])
    assert g.max() < table.shape[0] and torch.equal(got.view(torch.int32), want.view(torch.int32))
    # where a block's scratch exceeds the card's shared memory, the scratch
    # is the global workspace
    assert sc["wide"] == tmarch.SHARED
    huge = dataclasses.replace(big, max_samples=12_000)
    words = tmarch.wide_words(True, sc["mc"], 32, big.max_coarse_segments, 12_000, 16)[2]
    assert tmarch.WARPS * 4 * words > tmarch.SMEM_BYTES
    assert tmarch._scalars(gcfg, huge)["wide"] == tmarch.GLOBAL


# past K3's static layout (64 slots, 64 coarse segments, 64 rounds of 32
# candidates): configs the JAX package's march takes as any other
WIDE = {
    "k96": dict(max_samples=96, max_candidates=1024, proposal_samples=16),
    "segs96": dict(max_coarse_segments=96, max_candidates=1024),
    "flat4096": dict(hierarchical_march=False, max_candidates=4096),
    "all": dict(max_samples=96, max_coarse_segments=96, max_candidates=4096,
                proposal_samples=80),
}


@pytest.mark.parametrize("case", list(WIDE))
def test_march_past_the_static_layout_matches_jax(case):
    """march_ts_plain (K3's plain version, through march_rays) against
    the JAX package's march_rays at 96 samples, 96 coarse segments and
    4096 candidates, where K3 takes its wide layout: masks equal, the
    intervals within the parity march's tolerance."""
    import torch_parity
    from lsenerf_tpu.cameras.rays import RayBundle as JBundle
    from lsenerf_tpu_torch.cameras.rays import RayBundle as TBundle

    jm, tm = torch_parity.model_configs(model=WIDE[case])
    jmc, tmc = jm.march_config(), tm.march_config()
    gcfg = tocc.OccGridConfig(**torch_parity.GRID)
    sc = tmarch._scalars(gcfg, tmc)
    assert sc["wide"] and sc["hier"] == (case != "flat4096")
    assert tmarch.uses_proposal(tmc)
    rng = np.random.default_rng(7)
    n = 128
    d = rng.standard_normal((n, 3))
    o = (d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(1.2, 3.0, (n, 1)))
    dirs = rng.uniform(-0.6, 0.6, (n, 3)) - o
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    o, dirs = o.astype(np.float32), dirs.astype(np.float32)
    occs, binaries = torch_parity.sparse_grid(seed=2, radius=0.7)
    z1 = np.zeros((n, 1), np.float32)
    jb = JBundle(origins=jnp.asarray(o), directions=jnp.asarray(dirs),
                 pixel_area=jnp.asarray(z1), camera_indices=jnp.zeros((n, 1), jnp.int32))
    tb = TBundle(origins=torch.from_numpy(o), directions=torch.from_numpy(dirs),
                 pixel_area=torch.from_numpy(z1),
                 camera_indices=torch.zeros((n, 1), dtype=torch.int32))
    js = jmarch.march_rays(jb, jocc.OccGridState(occs=jnp.asarray(occs),
                                                 binaries=jnp.asarray(binaries)),
                           jocc.OccGridConfig(**torch_parity.GRID), jmc)
    state = tocc.OccGridState(occs=torch.from_numpy(occs), binaries=torch.from_numpy(binaries))
    ts = tmarch.march_rays(tb, state, gcfg, tmc)
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))
    np.testing.assert_allclose(ts.t_starts.numpy(), np.asarray(js.t_starts), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.t_ends.numpy(), np.asarray(js.t_ends), rtol=1e-5, atol=1e-6)
    counts = np.asarray(js.mask).sum(1)
    assert (counts == 0).any() and (counts > 0).any()
    if tmc.max_samples > 64:  # the selection fills slots past the static layout's 64
        pre = tmarch.march_ts_plain(tb.origins, tb.directions, None, None, state, gcfg,
                                    dataclasses.replace(tmc, proposal_samples=0))
        assert int(pre[2].sum(1).max()) > 64


def test_presets_take_the_static_layout():
    """Every preset's march (the flagship's, the CLI defaults', the tiny
    golden's) fits K3's static layout, whose kernel is the first redesign's."""
    from lsenerf_tpu_torch import flagship

    gcfg = tocc.OccGridConfig()
    for preset in flagship.PRESETS:
        cfg = flagship.preset_model_config(preset)
        for train in (True, False):
            assert not tmarch._scalars(cfg.grid, cfg.march_config(train))["wide"]
    assert not tmarch._scalars(gcfg, ModelConfig().march_config())["wide"]
    tiny = ModelConfig(max_samples=16, max_candidates=64)
    assert not tmarch._scalars(tocc.OccGridConfig(resolution=16, levels=1),
                               tiny.march_config())["wide"]


# the first design's MarchArgs (csrc/march.cu before the growth table)
FIRST_FIELDS = (
    [("o", "P"), ("d", "P"), ("nears", "P"), ("fars", "P"), ("bin", "P"), ("sup", "P"),
     ("occs", "P"), ("t_starts", "P"), ("t_ends", "P"), ("mask", "P")]
    + [(f, "i") for f in ("n", "levels", "R", "S", "hier", "packed", "cf", "mc", "k1", "k", "F",
                          "geo")]
    + [(f, "f") for f in ("aabb", "inv_aabb", "half", "neg_half", "near_plane", "far_plane",
                          "step", "inv_step", "t_crit", "base", "lam", "one_minus_lam", "inv_F",
                          "F_f")]
)


def test_march_args_begin_with_the_first_designs_fields():
    import ctypes

    kinds = {ctypes.c_void_p: "P", ctypes.c_int: "i", ctypes.c_float: "f"}
    fields = [(name, kinds[t]) for name, t in tmarch._MarchArgs._fields_]
    assert fields[: len(FIRST_FIELDS)] == FIRST_FIELDS
    assert fields[len(FIRST_FIELDS):] == [("growth", "P"), ("wide", "i"), ("scratch", "P")]
    # a call writes the ten pointers and n at once, where the struct has them
    assert tmarch._CALL.size == tmarch._MarchArgs.n.offset + ctypes.sizeof(ctypes.c_int)
    assert tmarch._MarchArgs.mask.offset == 9 * ctypes.sizeof(ctypes.c_void_p)


def test_model_config_keeps_its_march_config():
    cfg = ModelConfig()
    mcfg = cfg.march_config()
    assert cfg.march_config() is mcfg
    other = dataclasses.replace(cfg, max_samples=32)
    assert other.march_config().max_samples == 32 and mcfg.max_samples == cfg.max_samples
    assert dataclasses.replace(cfg).march_config() == mcfg
    # the eval renders' config: the same, without the proposal, and kept
    prop = dataclasses.replace(cfg, proposal_samples=16)
    ev = prop.march_config(train=False)
    assert prop.march_config(False) is ev and ev.proposal_samples == 0
    assert ev == dataclasses.replace(prop.march_config(), proposal_samples=0)
    assert cfg.march_config(train=False) is mcfg == dataclasses.replace(mcfg, proposal_samples=0)
