"""The port's march (lsenerf_tpu_torch/ops/march.py) off the flagship's
branch, against the JAX package on the CPU: the flat march at the tiny
golden's settings (64 candidates, a 16^3 x 1 grid, 16 samples,
scripts/parity.py --tiny), where 64 / 8 = 8 segments are too few for the
hierarchical branch; the flat march and the unpacked phase 2 switched on
by config at the parity grid (32^3 x 2, 256 candidates); and the per-ray
nears/fars clip. Masks and intervals are held equal, bit for bit, to
the JAX march run op by op (under jit XLA's fusions move some t by an
ulp)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsenerf_tpu.cameras.rays import RayBundle as JBundle
from lsenerf_tpu.models import lsenerf as jmodel
from lsenerf_tpu.ops import march as jmarch
from lsenerf_tpu.ops import occupancy as jocc
from lsenerf_tpu_torch.cameras.rays import RayBundle as TBundle
from lsenerf_tpu_torch.models import lsenerf as tmodel
from lsenerf_tpu_torch.ops import march as tmarch
from lsenerf_tpu_torch.ops import occupancy as tocc

import torch_parity

TINY_GRID = dict(resolution=16, levels=1)
# the tiny golden's march: 64 candidates, 16 samples; proposal F=16 is a
# no-op at 16 samples
TINY = dict(max_samples=16, max_candidates=64)
PARITY = dict(max_samples=16, max_candidates=256)
CASES = {
    "tiny_flat": (TINY, TINY_GRID, {}),
    "flat_by_config": (PARITY, torch_parity.GRID, dict(hierarchical_march=False)),
    "unpacked_phase2": (PARITY, torch_parity.GRID, dict(packed_phase2=False)),
}


def _rays(seed, n=256):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    origins = d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(0.4, 1.6, (n, 1))
    target = rng.uniform(-0.5, 0.5, (n, 3))
    dirs = target - origins
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return origins.astype(np.float32), dirs.astype(np.float32)


def _grid(kind, grid):
    if kind == "fresh":
        jg = jocc.OccGridConfig(**grid)
        # the draw init_occ_grid makes
        shape = (grid["levels"],) + (grid["resolution"],) * 3
        u = jax.random.uniform(jax.random.PRNGKey(961103), shape)
        st = jocc.init_occ_grid(jg)
        ts = tocc.init_occ_grid(tocc.OccGridConfig(**grid), jitter=torch.from_numpy(np.array(u)))
        np.testing.assert_allclose(ts.occs.numpy(), np.asarray(st.occs), rtol=1e-6)
        return np.array(st.occs), np.array(st.binaries)
    return torch_parity.sparse_grid(seed=4, radius=0.5, **grid)


@functools.lru_cache(maxsize=None)
def _unclipped(case, kind):
    return _march(case, kind)


def _march(case, kind, nears=None, fars=None):
    model, grid, march = CASES[case]
    kw = dict(model, **march)
    jmc = jmodel.ModelConfig(grid=jocc.OccGridConfig(**grid), **kw).march_config()
    tmc = tmodel.ModelConfig(grid=tocc.OccGridConfig(**grid), **kw).march_config()
    assert dataclasses.asdict(tmc).items() <= dataclasses.asdict(jmc).items()
    o, d = _rays(7)
    n = len(o)
    z1 = np.zeros((n, 1), np.float32)
    occs, binaries = _grid(kind, grid)
    extra = {k: v for k, v in (("nears", nears), ("fars", fars)) if v is not None}
    jb = JBundle(origins=jnp.asarray(o), directions=jnp.asarray(d), pixel_area=jnp.asarray(z1),
                 camera_indices=jnp.zeros((n, 1), jnp.int32),
                 **{k: jnp.asarray(v) for k, v in extra.items()})
    tb = TBundle(origins=torch.from_numpy(o), directions=torch.from_numpy(d),
                 pixel_area=torch.from_numpy(z1), camera_indices=torch.zeros((n, 1), dtype=torch.int32),
                 **{k: torch.from_numpy(v) for k, v in extra.items()})
    js = jmarch.march_rays(jb, jocc.OccGridState(occs=jnp.asarray(occs), binaries=jnp.asarray(binaries)),
                           jocc.OccGridConfig(**grid), jmc)
    ts = tmarch.march_rays(tb, tocc.OccGridState(occs=torch.from_numpy(occs),
                                                 binaries=torch.from_numpy(binaries)),
                           tocc.OccGridConfig(**grid), tmc)
    return js, ts


def _same(js, ts):
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))
    np.testing.assert_array_equal(ts.t_starts.numpy(), np.asarray(js.t_starts))
    np.testing.assert_array_equal(ts.t_ends.numpy(), np.asarray(js.t_ends))
    np.testing.assert_allclose(ts.positions.numpy(), np.asarray(js.positions), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["fresh", "sparse"])
@pytest.mark.parametrize("case", list(CASES))
def test_march_branch_matches(case, kind):
    js, ts = _unclipped(case, kind)
    _same(js, ts)
    counts = np.asarray(js.mask).sum(1)
    assert counts.max() > 0
    if kind == "sparse":  # some rays skip everything, some keep samples
        assert (counts == 0).any()


def test_tiny_golden_takes_the_flat_branch():
    """64 candidates in segments of 8 are 8 segments, not more than 24: the
    hierarchical conditions fail, and the flat march scans every
    candidate, so a fresh grid fills all 16 slots of most rays."""
    cfg = tmodel.ModelConfig(**TINY).march_config()
    assert cfg.hierarchical and cfg.max_candidates // cfg.coarse_factor <= cfg.max_coarse_segments
    js, ts = _unclipped("tiny_flat", "fresh")
    assert (ts.mask.sum(1) == 16).float().mean() > 0.5


@pytest.mark.parametrize("case", ["tiny_flat", "unpacked_phase2"])
def test_nears_fars_clip_matches(case):
    """Per-ray nears raise each ray's start and fars lower its end; some
    rays keep no sample."""
    rng = np.random.default_rng(11)
    n = 256
    nears = rng.uniform(0.0, 1.2, (n, 1)).astype(np.float32)
    fars = (nears + rng.uniform(0.05, 1.0, (n, 1))).astype(np.float32)
    js, ts = _march(case, "fresh", nears, fars)
    _same(js, ts)
    mask = np.asarray(js.mask)
    starts = np.asarray(js.t_starts)
    assert (starts[mask] >= np.broadcast_to(nears, mask.shape)[mask] - 1e-6).all()
    unclipped = _unclipped(case, "fresh")[0]
    assert mask.sum() < np.asarray(unclipped.mask).sum()
