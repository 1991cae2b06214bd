"""Small trainers for the tests of the bundles layer (the port's
ops/bundles.py: K8a/K8b and their plain version), one for each camera-pose
source a step's bundles take, and the composition of torch ops the layer
replaced, written out as the trainer had it, that the plain version is held
to. Imports only the port, so the card's tests use it too."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lsenerf_tpu_torch.cameras import cameras as tcams
from lsenerf_tpu_torch.cameras import pose_opt
from lsenerf_tpu_torch.data import datamanager as tdm
from lsenerf_tpu_torch.data import dataset as tds
from lsenerf_tpu_torch.data import synthetic as tsyn
from lsenerf_tpu_torch.engine import trainer as ttr
from lsenerf_tpu_torch.models import field as tfield
from lsenerf_tpu_torch.models import lsenerf as tmodel
from lsenerf_tpu_torch.ops import hash_encoding as the
from lsenerf_tpu_torch.ops import interp
from lsenerf_tpu_torch.ops import occupancy as tocc

SO3 = dict(mode="SO3xR3")
# a rigid RGB -> event extrinsic: a small rotation and a 5 cm baseline
_ANG = 0.05
DM = np.array([[np.cos(_ANG), 0.0, np.sin(_ANG), 0.05], [0.0, 1.0, 0.0, 0.01],
               [-np.sin(_ANG), 0.0, np.cos(_ANG), -0.02], [0.0, 0.0, 0.0, 1.0]], np.float32)

# the camera-pose source of each case: the RGB and event optimizers, and
# whether the run deblurs, has an extrinsic dM and explicit prev/next cameras
CASES = {
    "spline": dict(col=dict(mode="SO3xR3", optim_type="spline"), evs=SO3),
    "spline_deblur": dict(col=dict(mode="SO3xR3", optim_type="spline"), evs=SO3, deblur=True),
    "event_spline": dict(col=dict(mode="SO3xR3", optim_type="spline"),
                         evs=dict(mode="SO3xR3", optim_type="spline"), deblur=True, dM=True),
    "so3xr3": dict(col=SO3, evs=SO3),
    "se3": dict(col=dict(mode="SE3"), evs=dict(mode="SE3"), deblur=True),
    "prevnext": dict(col=dict(mode="SO3xR3", optim_type="spline"), evs=SO3, deblur=True,
                     prevnext=True),
    "none": dict(col=dict(mode="off"), evs=dict(mode="off"), deblur=True),
}


def _prevnext(evs):
    c = evs.cameras

    def sub(sl):
        return dataclasses.replace(c, camera_to_worlds=c.camera_to_worlds[sl], times=c.times[sl])

    return tds.EventFrameDataset(eimgs=evs.eimgs, cameras=c, e_thresh=evs.e_thresh,
                                 appearance_ids=evs.appearance_ids,
                                 prev_cameras=sub(slice(None, -1)), next_cameras=sub(slice(1, None)))


def case_trainer(case: str, device="cpu", n_cams: int = 6, size: int = 16, rays: int = 96,
                 seed: int = 0, rgb_only: bool = False) -> ttr.Trainer:
    """A tiny trainer whose bundles take `case`'s pose sources, with its
    camera leaves moved off their start (knots by ~0.03 rad and 3 cm,
    deltas by ~0.1, a 1.2 scale) so that every term is live."""
    c = CASES[case]
    col, evs = tsyn.make_synthetic_scene(n_cams=n_cams, h=size, w=size, focal=1.25 * size)
    if c.get("dM"):
        col.dM = DM
    if c.get("prevnext"):
        evs = _prevnext(evs)
    if rgb_only:
        evs = None
    deblur = c.get("deblur", False)
    dmc = tdm.DataManagerConfig(train_num_rays_per_batch=rays,
                                rgb_loss_mode="deblur" if deblur else "mse")
    mcfg = tmodel.ModelConfig(
        field=tfield.FieldConfig(hash=the.HashEncodingConfig(
            num_levels=2, base_res=4, max_res=8, layout="blocked", blocked_rows_log2=6)),
        grid=tocc.OccGridConfig(resolution=8, levels=1), max_samples=8, max_candidates=32,
        hierarchical_march=False, rgb_loss_type="deblur" if deblur else "linspace")
    cfg = ttr.TrainerConfig(col_cam_opt=ttr.CameraOptConfig(**c["col"]),
                            evs_cam_opt=ttr.CameraOptConfig(**c["evs"]))
    tr = ttr.Trainer(cfg, mcfg, tdm.MultiCamDataManager(dmc, col, evs, seed=seed), device=device)
    tr.setup()
    move_leaves(tr.params["camera_opt"], seed)
    return tr


def move_leaves(cam_params: dict, seed: int, knot: float = 0.03, delta: float = 0.1) -> None:
    """The camera leaves moved in place off their start, by `seed`."""
    g = np.random.default_rng(seed + 100)

    def noise(t, scale):
        return torch.from_numpy(g.standard_normal(tuple(t.shape)).astype(np.float32) * scale)

    with torch.no_grad():
        for path, t in ttr.tree_leaves(cam_params):
            if path.endswith("ctrl_tangents"):
                t += noise(t, knot).to(t.device)
            elif path.endswith("scale"):
                t.fill_(1.2)
            else:
                t += noise(t, delta).to(t.device)


def step_inputs(tr: ttr.Trainer, step: int = 0):
    """(parts, camera parameters, batch on the trainer's device, spline
    static, RGB times, appearance rows) of one step's bundles."""
    batch = tr.batch_to_device(tr.dm.next_train(step))
    return (tr._parts(), tr.params["camera_opt"], batch, tr.col_spline_static, tr.rgb_ts,
            tr.dm.num_embd)


def on_device(inputs, device):
    """step_inputs' tuple copied to `device`: the cameras, the leaves (as
    new leaves that take gradients), the batch, the spline and the times."""
    parts, cam_params, batch, spline, rgb_ts, num_embd = inputs

    def cams(c):
        return c.to(device)

    moved = {}
    parts = tuple(dataclasses.replace(p, cams=moved.setdefault(id(p.cams), cams(p.cams)))
                  for p in parts)

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        return t.detach().to(device).requires_grad_(t.requires_grad)

    if spline is not None:
        spline = dataclasses.replace(
            spline, ctrl_ts=spline.ctrl_ts.to(device),
            dM=None if spline.dM is None else spline.dM.to(device))
    return (parts, tree(cam_params), {k: v.to(device) for k, v in batch.items()}, spline,
            None if rgb_ts is None else rgb_ts.to(device), num_embd)


def today(tr: ttr.Trainer, cam_params: dict, batch: dict, gates, deblur=None, denerf=None):
    """The step's bundle as the trainer composed it before the bundles
    layer had a wrapper (its _make_col_bundle, _make_evs_bundles and the
    concatenation), with its RGB and event gates."""
    deblur = tr.model_config.rgb_loss_type == "deblur" if deblur is None else deblur
    denerf = tr._denerf() if denerf is None else denerf
    has_col, has_evs = tr._has()
    col_gate, evs_gate = gates
    out = []
    if has_col:
        cfg = tr.config.col_cam_opt
        cams = tr.col_cams
        idx = batch["col_indices"][:, 0]
        coords = batch["col_indices"][:, 1:].float()
        if deblur:
            idx_r, coords_r = idx.repeat_interleave(4), coords.repeat_interleave(4, dim=0)
        else:
            idx_r, coords_r = idx, coords
        if cfg.optim_type == "spline":
            times = cams.times[idx]
            static = tr.col_spline_static
            if deblur:
                c2w = pose_opt.spline_deblur_c2w(cam_params["col"], static, times[:, None], col_gate)
            else:
                c2w = pose_opt.spline_rgb_c2w(cam_params["col"], static, times, col_gate)
            bundle = tcams.generate_rays(cams, idx_r, coords_r, c2w=c2w)
        else:
            bundle = tcams.generate_rays(cams, idx_r, coords_r)
            if cfg.mode != "off":
                bundle = pose_opt.apply_pose_deltas_to_bundle(cam_params["col"], bundle, col_gate,
                                                              cfg.mode)
        app = batch["col_app_id"]
        if deblur:
            delta = torch.arange(4, device=app.device) - 2
            app = torch.clamp(app[:, None] + delta[None], 0, tr.dm.num_embd - 1).reshape(-1)
        out.append(bundle.replace(metadata={"appearance_id": app}))
    if has_evs:
        cfg = tr.config.evs_cam_opt
        idx = batch["evs_indices"][:, 0]
        coords = batch["evs_indices"][:, 1:].float()
        if tr.prev_cams is not None:
            prev = tcams.generate_rays(tr.prev_cams, idx, coords)
            nxt = tcams.generate_rays(tr.next_cams, idx, coords)
            if cfg.optim_type == "prevnext" and cfg.mode != "off":
                prev, nxt = pose_opt.apply_prevnext_to_bundles(cam_params["evs"], prev, nxt,
                                                               evs_gate, cfg.mode)
        elif cfg.optim_type == "spline":
            cams, static = tr.evs_cams, tr.col_spline_static
            c2w_p = pose_opt.spline_evs_c2w(cam_params["col"], static, cams.times[idx], evs_gate)
            c2w_n = pose_opt.spline_evs_c2w(cam_params["col"], static, cams.times[idx + 1],
                                            evs_gate)
            prev = tcams.generate_rays(cams, idx, coords, c2w=c2w_p)
            nxt = tcams.generate_rays(cams, idx + 1, coords, c2w=c2w_n)
        else:
            prev = tcams.generate_rays(tr.evs_cams, idx, coords)
            nxt = tcams.generate_rays(tr.evs_cams, idx + 1, coords)
            if cfg.mode != "off":
                prev = pose_opt.apply_pose_deltas_to_bundle(cam_params["evs"], prev, evs_gate,
                                                            cfg.mode)
                nxt = pose_opt.apply_pose_deltas_to_bundle(cam_params["evs"], nxt, evs_gate,
                                                           cfg.mode)
        app = batch["evs_app_id"]
        pair = []
        for b in (prev, nxt):
            b = b.replace(metadata={"appearance_id": app})
            if tr.rgb_ts is not None and b.times is not None:
                fixed = interp.find_closest_idxs(tr.rgb_ts, b.times[:, 0])
                b = b.replace(camera_indices=fixed[:, None].int())
            pair.append(b)
        out.extend(pair[:1] if denerf else pair)
    return tmodel.concat_bundles(out) if len(out) > 1 else out[0]


FIELDS = ("origins", "directions", "pixel_area", "camera_indices", "times")


def cotangents(n: int, seed: int = 7):
    """Fixed weights of a linear loss on origins, directions and
    pixel_area (the last scaled up: an area is ~1e-3)."""
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.standard_normal(shape).astype(np.float32) * s)
            for shape, s in (((n, 3), 1.0), ((n, 3), 1.0), ((n, 1), 1e3))]


def loss_of(bundle, cots) -> torch.Tensor:
    dev = bundle.origins.device
    wo, wd, wa = (c.to(dev) for c in cots)
    return ((bundle.origins * wo).sum() + (bundle.directions * wd).sum()
            + (bundle.pixel_area * wa).sum())


def leaf_grads(cam_params: dict) -> dict:
    """{path: the leaf's gradient (None where it has none)} of the camera
    leaves, on the CPU."""
    return {p: None if t.grad is None else t.grad.detach().cpu()
            for p, t in ttr.tree_leaves(cam_params)}
