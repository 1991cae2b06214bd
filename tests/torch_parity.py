"""Shared builders for the PyTorch-port parity tests (tests/test_torch_*.py):
one small configuration built twice, once from the JAX package and once
from the port, so both run the same branches on the same inputs.

The configuration takes the flagship's branches at a small size: a blocked
hash grid with dense and hashed levels (or an ngp one, `layout="ngp"`), a 32^3 x 2 occupancy grid with 256
candidates (hierarchical march with the packed phase-2 rule: 256 % 8 == 0,
32 % 8 == 0, (32/8) % 4 == 0, 256/8 > 24, 8^3 % 32 == 0), 16 samples
resampled to 8 by the proposal, co_map with identity/powpow mappers and
SO3xR3 `ns` camera deltas. f32 throughout unless a test asks for bf16.
`trainers` also takes the other camera optimizers (spline, prevnext, SE3
deltas), deblur, an RGB-to-event extrinsic, explicit prev/next event
cameras, model, hash and grid overrides (the other map modes, mappers,
embeddings, event losses, backgrounds and marches) and an RGB-only run."""

from __future__ import annotations

import numpy as np

from lsenerf_tpu.cameras import cameras as jcams
from lsenerf_tpu.data import datamanager as jdm
from lsenerf_tpu.data import dataset as jds
from lsenerf_tpu.data import synthetic as jsyn
from lsenerf_tpu.engine import trainer as jtr
from lsenerf_tpu.models import embeddings as jemb
from lsenerf_tpu.models import field as jfield
from lsenerf_tpu.models import lsenerf as jmodel
from lsenerf_tpu.ops import hash_encoding as jhe
from lsenerf_tpu.ops import occupancy as jocc
from lsenerf_tpu_torch.cameras import cameras as tcams
from lsenerf_tpu_torch.data import datamanager as tdm
from lsenerf_tpu_torch.data import dataset as tds
from lsenerf_tpu_torch.data import synthetic as tsyn
from lsenerf_tpu_torch.engine import trainer as ttr
from lsenerf_tpu_torch.models import embeddings as temb
from lsenerf_tpu_torch.models import field as tfield
from lsenerf_tpu_torch.models import lsenerf as tmodel
from lsenerf_tpu_torch.ops import hash_encoding as the
from lsenerf_tpu_torch.ops import occupancy as tocc

# res 4..128 over 6 levels; blocked: 2^10 rows per hashed level, levels 0-2
# dense; ngp: 2^10 entries a level
HASH = dict(num_levels=6, base_res=4, max_res=128, blocked_rows_log2=10, log2_hashmap_size=10)
GRID = dict(resolution=32, levels=2)
MODEL = dict(
    max_samples=16, max_candidates=256, proposal_samples=8, use_mapping=True,
    map_mode="co_map", mapping_method="identity", evs_mapping_method="powpow", ev_one_dim="gt",
)
SCENE = dict(n_cams=6, h=16, w=16, focal=20.0)


def hash_configs(dtype="float32", layout="blocked", **over):
    """(JAX, port) HashEncodingConfig of HASH in `layout`, updated by `over`."""
    kw = dict(HASH, gather_dtype=dtype, layout=layout)
    kw.update(over)
    # dense_grad_rows=64 keeps the JAX blocked backward's default split:
    # exact one-hot sums on the dense levels, the sorted windows on hashed
    # ones (the port's grad_overflow count skips the same levels); the
    # Pallas combine runs in interpret mode
    j = jhe.HashEncodingConfig(combine_impl="pallas", dense_grad_rows=64, **kw)
    return j, the.HashEncodingConfig(dense_grad_rows=64, **kw)


def model_configs(dtype="float32", rgb_loss_type="linspace", model=None, hash=None,
                  grid=None, emb="global_emb", layout="blocked", field=None):
    """(JAX ModelConfig, port ModelConfig): MODEL updated by `model`, HASH
    in `layout` by `hash`, GRID by `grid`, FieldConfig fields (coarse_stride,
    coarse_levels, use_contraction) from `field`, with embedding type
    `emb`."""
    jh, th = hash_configs(dtype, layout, **(hash or {}))
    kw = dict(MODEL, rgb_loss_type=rgb_loss_type, **(model or {}))
    g = dict(GRID, **(grid or {}))
    f = dict(compute_dtype=dtype, **(field or {}))
    j = jmodel.ModelConfig(
        field=jfield.FieldConfig(hash=jh, embedding=jemb.EmbeddingConfig(embedding_type=emb), **f),
        grid=jocc.OccGridConfig(**g), **kw,
    )
    t = tmodel.ModelConfig(
        field=tfield.FieldConfig(hash=th, embedding=temb.EmbeddingConfig(embedding_type=emb), **f),
        grid=tocc.OccGridConfig(**g), **kw,
    )
    return j, t


def sparse_grid(seed=0, radius=0.8, resolution=GRID["resolution"], levels=GRID["levels"]):
    """An occupancy EMA that is empty outside a ball, plus its binaries."""
    R, L = resolution, levels
    rng = np.random.default_rng(seed)
    c = (np.arange(R) + 0.5) / R * 2.0 - 1.0
    dist = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2)
    # a level at a time (the draws of one (L, R, R, R) call): large grids
    # keep one level's f64 arrays at once
    occs = np.stack([(rng.random((R, R, R)) * 0.5 * (dist * 2.0**lvl < radius)).astype(np.float32)
                     for lvl in range(L)])
    return occs, occs > min(float(occs.mean()), 0.01)


def with_prevnext(evs, ds, cams, as_array):
    """The event dataset `evs` again, from the same numpy arrays, with
    explicit prev = cameras[:-1] and next = cameras[1:]: `ds` and `cams`
    are one package's dataset and cameras modules, `as_array` its numpy ->
    array conversion."""
    c = evs.cameras
    c2w, times = np.asarray(c.camera_to_worlds), np.asarray(c.times)

    def sub(sl):
        return cams.Cameras(camera_to_worlds=as_array(c2w[sl]), fx=c.fx, fy=c.fy, cx=c.cx,
                            cy=c.cy, width=c.width, height=c.height, times=as_array(times[sl]))

    return ds.EventFrameDataset(
        eimgs=evs.eimgs, cameras=c, e_thresh=evs.e_thresh, appearance_ids=evs.appearance_ids,
        prev_cameras=sub(slice(None, -1)), next_cameras=sub(slice(1, None)),
    )


CAM = dict(mode="SO3xR3", optim_type="ns")


def trainers(dtype="float32", rays=96, dm_seed=0, col_cam=CAM, evs_cam=CAM, deblur=False,
             dM=None, prevnext=False, model=None, hash=None, grid=None, emb="global_emb",
             rgb_frac=0.66, fresh_grid=False, layout="blocked", field=None):
    """(JAX trainer, its state, port trainer set up with the JAX params).
    `col_cam`/`evs_cam` are CameraOptConfig fields; `deblur` sets both the
    model's rgb_loss_type and the data manager's rgb_loss_mode; `dM` is
    set on both colour datasets; `prevnext` gives both event datasets
    explicit prev/next cameras; `model`, `hash`, `grid`, `emb`, `layout`
    and `field` go to model_configs; `rgb_frac` 1.0 is an RGB-only run, with no event
    dataset (as train.py builds it); `fresh_grid` keeps JAX's fresh
    (jittered, all occupied) occupancy grid in place of sparse_grid()."""
    import jax
    import torch

    from lsenerf_tpu_torch import convert

    jm, tm = model_configs(dtype, "deblur" if deblur else "linspace", model, hash, grid, emb,
                           layout, field)
    dmc = dict(train_num_rays_per_batch=rays, rgb_frac=rgb_frac,
               rgb_loss_mode="deblur" if deblur else "mse")
    jcol, jevs = jsyn.make_synthetic_scene(**SCENE)
    tcol, tevs = tsyn.make_synthetic_scene(**SCENE)
    if rgb_frac >= 1.0:
        jevs = tevs = None
    if dM is not None:
        jcol.dM = tcol.dM = np.asarray(dM, np.float32)
    if prevnext:
        jevs = with_prevnext(jevs, jds, jcams, jax.numpy.asarray)
        tevs = with_prevnext(tevs, tds, tcams, torch.from_numpy)
    jd = jdm.MultiCamDataManager(jdm.DataManagerConfig(**dmc), jcol, jevs, seed=dm_seed)
    jt = jtr.Trainer(
        jtr.TrainerConfig(col_cam_opt=jtr.CameraOptConfig(**col_cam),
                          evs_cam_opt=jtr.CameraOptConfig(**evs_cam)),
        jm, jd,
    )
    state = jt.setup(jax.random.PRNGKey(0))
    td = tdm.MultiCamDataManager(tdm.DataManagerConfig(**dmc), tcol, tevs, seed=dm_seed)
    tt = ttr.Trainer(
        ttr.TrainerConfig(col_cam_opt=ttr.CameraOptConfig(**col_cam),
                          evs_cam_opt=ttr.CameraOptConfig(**evs_cam)),
        tm, td, device="cpu",
    )
    p = jax.tree.map(np.asarray, state.params)
    if fresh_grid:
        occs, binaries = np.asarray(state.occ.occs), np.asarray(state.occ.binaries)
    else:
        occs, binaries = sparse_grid(**{k: v for k, v in (grid or {}).items()
                                        if k in ("resolution", "levels")})
    tt.setup(params=convert.params_from_numpy(p["model"], p["camera_opt"], hash_layout=layout),
             occ=convert.occ_state_from_numpy(occs, binaries))
    state = state.replace(occ=jocc.OccGridState(
        occs=jax.numpy.asarray(occs), binaries=jax.numpy.asarray(binaries)))
    return jt, state, tt
