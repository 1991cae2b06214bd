"""Shared builders for the PyTorch-port parity tests (tests/test_torch_*.py):
one small configuration built twice, once from the JAX package and once
from the port, so both run the same branches on the same inputs.

The configuration takes the flagship's branches at a small size: a blocked
hash grid with dense and hashed levels, a 32^3 x 2 occupancy grid with 256
candidates (hierarchical march with the packed phase-2 rule: 256 % 8 == 0,
32 % 8 == 0, (32/8) % 4 == 0, 256/8 > 24, 8^3 % 32 == 0), 16 samples
resampled to 8 by the proposal, co_map with identity/powpow mappers and
SO3xR3 `ns` camera deltas. f32 throughout unless a test asks for bf16."""

from __future__ import annotations

import numpy as np

from lsenerf_tpu.data import datamanager as jdm
from lsenerf_tpu.data import synthetic as jsyn
from lsenerf_tpu.engine import trainer as jtr
from lsenerf_tpu.models import field as jfield
from lsenerf_tpu.models import lsenerf as jmodel
from lsenerf_tpu.ops import hash_encoding as jhe
from lsenerf_tpu.ops import occupancy as jocc
from lsenerf_tpu_torch.data import datamanager as tdm
from lsenerf_tpu_torch.data import synthetic as tsyn
from lsenerf_tpu_torch.engine import trainer as ttr
from lsenerf_tpu_torch.models import field as tfield
from lsenerf_tpu_torch.models import lsenerf as tmodel
from lsenerf_tpu_torch.ops import hash_encoding as the
from lsenerf_tpu_torch.ops import occupancy as tocc

# res 4..128 over 6 levels; 2^10 rows per hashed level: levels 0-2 dense
HASH = dict(num_levels=6, base_res=4, max_res=128, blocked_rows_log2=10)
GRID = dict(resolution=32, levels=2)
MODEL = dict(
    max_samples=16, max_candidates=256, proposal_samples=8,
    mapping_method="identity", evs_mapping_method="powpow", ev_one_dim="gt",
)
# the JAX options whose values the port has built in
JAX_ONLY = dict(packed_phase2=True, use_mapping=True, map_mode="co_map",
                rgb_loss_type="linspace")
SCENE = dict(n_cams=6, h=16, w=16, focal=20.0)


def hash_configs(dtype="float32", **over):
    kw = dict(HASH, gather_dtype=dtype, **over)
    # dense_grad_rows=64 keeps the JAX backward's default split: exact
    # one-hot sums on the dense levels, the sorted windows on hashed ones
    j = jhe.HashEncodingConfig(layout="blocked", combine_impl="pallas",
                               dense_grad_rows=64, **kw)
    return j, the.HashEncodingConfig(**kw)


def model_configs(dtype="float32"):
    jh, th = hash_configs(dtype)
    j = jmodel.ModelConfig(
        field=jfield.FieldConfig(hash=jh, compute_dtype=dtype),
        grid=jocc.OccGridConfig(**GRID), **MODEL, **JAX_ONLY,
    )
    t = tmodel.ModelConfig(
        field=tfield.FieldConfig(hash=th, compute_dtype=dtype),
        grid=tocc.OccGridConfig(**GRID), **MODEL,
    )
    return j, t


def sparse_grid(seed=0, radius=0.8):
    """An occupancy EMA that is empty outside a ball, plus its binaries."""
    R, L = GRID["resolution"], GRID["levels"]
    rng = np.random.default_rng(seed)
    c = (np.arange(R) + 0.5) / R * 2.0 - 1.0
    halves = 2.0 ** np.arange(L)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    dist = np.sqrt(x**2 + y**2 + z**2)[None] * halves[:, None, None, None]
    occs = (rng.random((L, R, R, R)) * 0.5 * (dist < radius)).astype(np.float32)
    return occs, occs > min(float(occs.mean()), 0.01)


def trainers(dtype="float32", rays=96, dm_seed=0):
    """(JAX trainer, its state, port trainer set up with the JAX params)."""
    import jax

    from lsenerf_tpu_torch import convert

    jm, tm = model_configs(dtype)
    cam = dict(mode="SO3xR3", optim_type="ns")
    jcol, jevs = jsyn.make_synthetic_scene(**SCENE)
    jd = jdm.MultiCamDataManager(
        jdm.DataManagerConfig(train_num_rays_per_batch=rays), jcol, jevs, seed=dm_seed
    )
    jt = jtr.Trainer(
        jtr.TrainerConfig(col_cam_opt=jtr.CameraOptConfig(**cam),
                          evs_cam_opt=jtr.CameraOptConfig(**cam)),
        jm, jd,
    )
    state = jt.setup(jax.random.PRNGKey(0))
    tcol, tevs = tsyn.make_synthetic_scene(**SCENE)
    td = tdm.MultiCamDataManager(
        tdm.DataManagerConfig(train_num_rays_per_batch=rays), tcol, tevs, seed=dm_seed
    )
    tt = ttr.Trainer(
        ttr.TrainerConfig(col_cam_opt=ttr.CameraOptConfig(**cam),
                          evs_cam_opt=ttr.CameraOptConfig(**cam)),
        tm, td, device="cpu",
    )
    p = jax.tree.map(np.asarray, state.params)
    occs, binaries = sparse_grid()
    tt.setup(params=convert.params_from_numpy(p["model"], p["camera_opt"]),
             occ=convert.occ_state_from_numpy(occs, binaries))
    state = state.replace(occ=jocc.OccGridState(
        occs=jax.numpy.asarray(occs), binaries=jax.numpy.asarray(binaries)))
    return jt, state, tt
