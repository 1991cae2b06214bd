"""Trainer: parameters, the three-bundle train step, Adam in two groups and
the occupancy-grid cadence. Port of lsenerf_tpu/engine/trainer.py for the
train mode: the camera optimizers `ns` (SO3xR3 or SE3 deltas), `spline`
(the RGB spline, with deblur's 4 exposure poses, and the event cameras on
it through dM) and `prevnext` (explicit prev/next event cameras, detected
from the dataset), and deblur with any of them. The eval and pretrain
modes and data parallelism are not ported yet.

`Trainer.step(batch)` is the public entry. PyTorch runs eagerly, so there
is no jitted step: the step is the forward, `backward()` and the optimizer
update, on `self.device`.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field, replace
from typing import Optional

import numpy as np
import torch

from lsenerf_tpu_torch import resolve_device
from lsenerf_tpu_torch.cameras import cameras as cam_lib
from lsenerf_tpu_torch.cameras import pose_opt
from lsenerf_tpu_torch.data.datamanager import MultiCamDataManager
from lsenerf_tpu_torch.engine.schedules import exponential_decay
from lsenerf_tpu_torch.models import field as field_lib
from lsenerf_tpu_torch.models import lsenerf as model_lib
from lsenerf_tpu_torch.ops import interp
from lsenerf_tpu_torch.ops import occupancy as occ_lib

OCC_CHUNK = 131072  # positions per density chunk of the occupancy update


@dataclass
class OptimizerGroupConfig:
    lr: float = 1e-2
    eps: float = 1e-15
    lr_final: float = 1e-4
    max_steps: int = 200000


@dataclass
class CameraOptConfig:
    mode: str = "off"  # off | SO3xR3 | SE3
    optim_type: str = "ns"  # ns | spline | prevnext
    scheme: str = "active"  # active | delayed
    delay_cnt: int = 10000
    exp_t: float = 30000.0  # exposure time, for deblur's spline poses
    control_pnt_factor: int = 1  # spline knots per camera interval

    def __post_init__(self):
        if self.optim_type not in ("ns", "spline", "prevnext"):
            raise ValueError(f"unknown camera optim_type {self.optim_type!r}")
        if self.mode not in ("off", "SO3xR3", "SE3"):
            raise ValueError(f"unknown camera-opt mode {self.mode!r}")
        if self.mode == "off":
            self.scheme = "active"


@dataclass
class TrainerConfig:
    seed: int = 42
    fields_optimizer: OptimizerGroupConfig = dc_field(default_factory=OptimizerGroupConfig)
    camera_optimizer: OptimizerGroupConfig = dc_field(
        default_factory=lambda: OptimizerGroupConfig(lr=1e-3, lr_final=1e-4, max_steps=5000)
    )
    col_cam_opt: CameraOptConfig = dc_field(default_factory=CameraOptConfig)
    evs_cam_opt: CameraOptConfig = dc_field(default_factory=CameraOptConfig)


def tree_leaves(tree: dict, prefix: str = ""):
    """(path, tensor) pairs of a nested dict, paths joined with '/'."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from tree_leaves(v, path)
        else:
            yield path, v


def build_optimizer(config: TrainerConfig, params: dict):
    """Adam over two groups, "fields" (params['model']) and "camera_opt"
    (params['camera_opt']), eps 1e-15, each with its exponential decay.
    Returns (optimizer, per-group schedules); the caller sets each group's
    lr to schedule(step) before the update with step = updates done so far,
    the count optax passes to its schedule."""
    groups, schedules = [], []
    for name, g in (("model", config.fields_optimizer), ("camera_opt", config.camera_optimizer)):
        leaves = [t for _, t in tree_leaves(params[name])]
        if not leaves:
            continue
        groups.append({"params": leaves, "lr": g.lr, "eps": g.eps, "name": name})
        schedules.append(exponential_decay(g.lr, g.lr_final, g.max_steps))
    return torch.optim.Adam(groups, betas=(0.9, 0.999)), schedules


class Trainer:
    """Owns the data manager, configs, parameters, optimizer and grid."""

    def __init__(self, config: TrainerConfig, model_config: model_lib.ModelConfig,
                 dm: MultiCamDataManager, device=None, all_cameras=None):
        """`all_cameras`: the full RGB trajectory the spline's knots are
        placed on, where the train split is only part of it; by default
        the train cameras."""
        self.model_config = model_config.normalized()
        self.dm = dm
        self.device = resolve_device(device)
        self.col_cams = dm.col.cameras.to(self.device) if dm.col is not None else None
        self.evs_cams = dm.evs.cameras.to(self.device) if dm.evs is not None else None
        self.rgb_ts = self.col_cams.times if self.col_cams is not None else None

        self.col_spline_params = self.col_spline_static = None
        cc = config.col_cam_opt
        if cc.optim_type == "spline":
            cams = all_cameras if all_cameras is not None else dm.col.cameras
            c2w = cams.camera_to_worlds.cpu().numpy()
            bottom = np.broadcast_to(np.array([[[0.0, 0, 0, 1]]], np.float32), (len(cams), 1, 4))
            self.col_spline_params, self.col_spline_static = pose_opt.init_spline(
                np.concatenate([c2w, bottom], axis=1), cams.times.cpu().numpy(),
                control_pnt_factor=cc.control_pnt_factor, dM=getattr(dm.col, "dM", None),
                exp_t=cc.exp_t, device=self.device,
            )

        # explicit prev/next event cameras select the prevnext optimizer
        self.prev_cams = self.next_cams = None
        if dm.evs is not None and dm.evs.prev_cameras is not None:
            self.prev_cams = dm.evs.prev_cameras.to(self.device)
            self.next_cams = dm.evs.next_cameras.to(self.device)
            if config.evs_cam_opt.optim_type != "spline":
                config = replace(config, evs_cam_opt=replace(config.evs_cam_opt, optim_type="prevnext"))
        self.config = config
        self.params = None
        self.occ = None
        self.step_count = 0

    # -- init ----------------------------------------------------------------

    def init_params(self, generator: torch.Generator) -> dict:
        model = model_lib.init_model(generator, self.model_config, num_imgs=self.dm.num_embd,
                                     device=self.device)
        cam = {"col": {}, "evs": {}}
        cc, ec = self.config.col_cam_opt, self.config.evs_cam_opt
        if cc.optim_type == "spline":
            cam["col"] = {k: v.clone() for k, v in self.col_spline_params.items()}
        elif cc.mode != "off" and self.dm.col is not None:
            cam["col"] = pose_opt.init_pose_deltas(len(self.dm.col.cameras), self.device)
        if self.dm.evs is not None and ec.optim_type == "prevnext":
            cam["evs"] = pose_opt.init_prevnext_deltas(len(self.prev_cams), self.device)
        elif self.dm.evs is not None and ec.optim_type == "ns" and ec.mode != "off":
            cam["evs"] = pose_opt.init_pose_deltas(len(self.dm.evs.cameras), self.device)
        return {"model": model, "camera_opt": cam}

    def setup(self, params: Optional[dict] = None,
              occ: Optional[occ_lib.OccGridState] = None) -> None:
        """Fresh parameters from the config seed unless `params` (a nested
        dict of tensors, e.g. from convert.py) is given; likewise the grid."""
        seed = self.config.seed
        if params is None:
            params = self.init_params(torch.Generator(device=self.device).manual_seed(seed))
        self.params = _as_leaves(params, self.device)
        self.occ = occ if occ is not None else occ_lib.init_occ_grid(
            self.model_config.grid, self.device
        )
        self.optimizer, self.schedules = build_optimizer(self.config, self.params)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.step_count = 0

    # -- bundles -------------------------------------------------------------

    def _make_col_bundle(self, cam_params, batch, gate):
        """RGB rays; under deblur 4 a pixel, the 4 of a pixel together, on
        the spline's exposure poses or else on the pixel's one pose."""
        cfg = self.config.col_cam_opt
        cams = self.col_cams
        idx = batch["col_indices"][:, 0]
        coords = batch["col_indices"][:, 1:].float()
        deblur = self.model_config.rgb_loss_type == "deblur"
        if deblur:
            idx_r, coords_r = idx.repeat_interleave(4), coords.repeat_interleave(4, dim=0)
        else:
            idx_r, coords_r = idx, coords
        if cfg.optim_type == "spline":
            times = cams.times[idx]
            static = self.col_spline_static
            if deblur:
                c2w = pose_opt.spline_deblur_c2w(cam_params["col"], static, times[:, None], gate)
            else:
                c2w = pose_opt.spline_rgb_c2w(cam_params["col"], static, times, gate)
            bundle = cam_lib.generate_rays(cams, idx_r, coords_r, c2w=c2w)
        else:
            bundle = cam_lib.generate_rays(cams, idx_r, coords_r)
            if cfg.mode != "off":
                bundle = pose_opt.apply_pose_deltas_to_bundle(cam_params["col"], bundle, gate, cfg.mode)
        app = batch["col_app_id"]
        if deblur:
            # the exposure rays take the neighbouring appearance ids
            delta = torch.arange(4, device=app.device) - 2
            app = torch.clamp(app[:, None] + delta[None], 0, self.dm.num_embd - 1).reshape(-1)
        return bundle.replace(metadata={"appearance_id": app})

    def _make_evs_bundles(self, cam_params, batch, gate):
        """Frame i spans prev_cameras[i] and next_cameras[i] where the
        dataset has them, else cameras i and i+1 (on the spline through dM
        when the event cameras use it)."""
        cfg = self.config.evs_cam_opt
        idx = batch["evs_indices"][:, 0]
        coords = batch["evs_indices"][:, 1:].float()
        if self.prev_cams is not None:
            prev = cam_lib.generate_rays(self.prev_cams, idx, coords)
            nxt = cam_lib.generate_rays(self.next_cams, idx, coords)
            if cfg.optim_type == "prevnext" and cfg.mode != "off":
                prev, nxt = pose_opt.apply_prevnext_to_bundles(cam_params["evs"], prev, nxt, gate, cfg.mode)
        elif cfg.optim_type == "spline":
            cams, static = self.evs_cams, self.col_spline_static
            c2w_p = pose_opt.spline_evs_c2w(cam_params["col"], static, cams.times[idx], gate)
            c2w_n = pose_opt.spline_evs_c2w(cam_params["col"], static, cams.times[idx + 1], gate)
            prev = cam_lib.generate_rays(cams, idx, coords, c2w=c2w_p)
            nxt = cam_lib.generate_rays(cams, idx + 1, coords, c2w=c2w_n)
        else:
            prev = cam_lib.generate_rays(self.evs_cams, idx, coords)
            nxt = cam_lib.generate_rays(self.evs_cams, idx + 1, coords)
            if cfg.mode != "off":
                prev = pose_opt.apply_pose_deltas_to_bundle(cam_params["evs"], prev, gate, cfg.mode)
                nxt = pose_opt.apply_pose_deltas_to_bundle(cam_params["evs"], nxt, gate, cfg.mode)
        app = batch["evs_app_id"]
        out = []
        for b in (prev, nxt):
            b = b.replace(metadata={"appearance_id": app})
            # CameraIdxFixer: snap event times to the nearest RGB camera
            if self.rgb_ts is not None and b.times is not None:
                fixed = interp.find_closest_idxs(self.rgb_ts, b.times[:, 0])
                b = b.replace(camera_indices=fixed[:, None].int())
            out.append(b)
        return out[0], out[1]

    # -- the step ------------------------------------------------------------

    def _has(self):
        c = self.dm.config
        has_col = c.train_num_col_rays_per_batch > 0 and self.dm.col is not None
        has_evs = c.train_num_evs_rays_per_batch > 0 and self.dm.evs is not None
        return has_col, has_evs

    def batch_to_device(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            dtype = torch.long if np.issubdtype(v.dtype, np.integer) else torch.float32
            out[k] = torch.as_tensor(v, dtype=dtype).to(self.device, non_blocking=True)
        return out

    def _denerf(self) -> bool:
        """The denerf shortcut: the next event bundle is not rendered and
        the event loss reads the prev bundle's output twice."""
        return "denerf" in self.model_config.event_loss_type

    def num_rays(self, batch: dict) -> int:
        """Rays one step renders for this batch (the background's rows)."""
        has_col, has_evs = self._has()
        n = 0
        if has_col:
            n += len(batch["col_indices"]) * (4 if self.model_config.rgb_loss_type == "deblur" else 1)
        if has_evs:
            n += (1 if self._denerf() else 2) * len(batch["evs_indices"])
        return n

    def loss_fn(self, params: dict, occ, batch: dict, step: int, bg_color=None):
        """(params, occ, batch, step, background) -> (loss, metrics): one
        volume render for all bundles (RGB, prev and next event; no next
        under denerf), split and post-processed per branch."""
        mcfg, tcfg = self.model_config, self.config
        has_col, has_evs = self._has()
        cam_params = params["camera_opt"]
        col_gate = pose_opt.activation_gate(step, tcfg.col_cam_opt.scheme, tcfg.col_cam_opt.delay_cnt)
        evs_gate = pose_opt.activation_gate(step, tcfg.evs_cam_opt.scheme, tcfg.evs_cam_opt.delay_cnt)
        col_out = prev_out = next_out = col_batch = evs_batch = None
        bundles = []
        if has_col:
            bundles.append(self._make_col_bundle(cam_params, batch, col_gate))
            col_batch = {"image": batch["col_rgb"]}
        denerf = self._denerf()
        if has_evs:
            prev_b, next_b = self._make_evs_bundles(cam_params, batch, evs_gate)
            bundles.extend([prev_b] if denerf else [prev_b, next_b])
            evs_batch = {"image": batch["evs_values"], "e_thresh": batch["e_thresh"]}
        sizes = [len(b) for b in bundles]
        big = model_lib.concat_bundles(bundles) if len(bundles) > 1 else bundles[0]
        raw = model_lib.render_bundle(params["model"], big, occ, mcfg, train=True, bg_color=bg_color)
        offs = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        cursor = 0
        if has_col:
            col_out = model_lib.postprocess_outputs(
                params["model"], model_lib.slice_outputs(raw, offs[0], offs[1]),
                mcfg, train=True, ev_out=False,
            )
            cursor = 1
        if has_evs:
            ev_outs = [
                model_lib.postprocess_outputs(
                    params["model"], model_lib.slice_outputs(raw, offs[j], offs[j + 1]),
                    mcfg, train=True, ev_out=True,
                )
                for j in range(cursor, len(bundles))
            ]
            prev_out, next_out = ev_outs[0], ev_outs[-1]
        loss_dict = model_lib.compute_losses(
            params["model"], mcfg, col_out, prev_out, next_out, col_batch, evs_batch
        )
        total = sum(loss_dict.values())
        metrics = dict(loss_dict)
        metrics.update(self._camera_metrics(cam_params))
        if col_out is not None:
            mse = ((col_out["rgb"] - col_batch["image"]) ** 2).mean()
            metrics["psnr"] = -10.0 * torch.log10(mse)
            metrics["num_samples_per_ray"] = col_out["num_samples_per_ray"].float().mean()
        return total, metrics

    def _camera_metrics(self, cam_params: dict) -> dict:
        """Norms of the active optimizers' parameters: the deltas (per
        branch for prevnext), or the spline knots' drift from the
        trajectory this trainer initialised and the scale's from 1."""
        metrics = {}

        def norms(key, pa):
            pa = pa.detach()
            metrics[f"camera_opt_translation_{key}"] = torch.linalg.norm(pa[:, :3])
            metrics[f"camera_opt_rotation_{key}"] = torch.linalg.norm(pa[:, 3:])

        for name, cp in cam_params.items():
            if "pose_adjustment" in cp:
                norms(name, cp["pose_adjustment"])
            for sub in ("prev", "next"):
                if sub in cp:
                    norms(f"{name}_{sub}", cp[sub]["pose_adjustment"])
            if "ctrl_tangents" in cp and self.col_spline_params is not None:
                norms(name, cp["ctrl_tangents"] - self.col_spline_params["ctrl_tangents"])
                metrics[f"camera_opt_scale_drift_{name}"] = (cp["scale"].detach()[0] - 1.0).abs()
        return metrics

    def _draw_background(self, n: int):
        """The random background's colours, one a rendered ray; None for
        the other backgrounds, which need none."""
        if self.model_config.background_color != "random":
            return None
        return torch.rand((n, 3), generator=self._gen, device=self.device)

    def grads(self, batch: dict, bg_color=None):
        """Loss, metrics and the gradients (a dict path -> tensor) of one
        step's loss at the current parameters; nothing is updated. A leaf
        outside this step's graph (the spline's scale when the event
        cameras are not on the spline, rgb_to_one when the event branch
        does not read it) gets zeros, as JAX gives it; its .grad stays
        None, so Adam leaves it as it is."""
        if bg_color is None:
            bg_color = self._draw_background(self.num_rays(batch))
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss_fn(self.params, self.occ, batch, self.step_count, bg_color)
        loss.backward()
        grads = {p: torch.zeros_like(t) if t.grad is None else t.grad
                 for p, t in tree_leaves(self.params)}
        return loss, metrics, grads

    def step(self, batch: dict, bg_color=None) -> dict:
        """One training step on a data-manager batch (numpy or tensors).
        Runs the occupancy update first every `update_interval` steps, as
        the JAX training loop does. Returns detached metric tensors."""
        if self.step_count % self.model_config.grid.update_interval == 0:
            self.occ_update()
        batch = self.batch_to_device(batch)
        loss, metrics, _ = self.grads(batch, bg_color)
        for group, sched in zip(self.optimizer.param_groups, self.schedules):
            group["lr"] = sched(self.step_count)
        self.optimizer.step()
        self.step_count += 1
        metrics["loss"] = loss
        return {k: v.detach() for k, v in metrics.items()}

    # -- occupancy maintenance ------------------------------------------------

    @torch.no_grad()
    def occ_update(self, cell_ids=None, positions=None) -> None:
        """Sampled EMA update: densities at random jittered cells of every
        level, evaluated in chunks of OCC_CHUNK positions. The tests pass
        the JAX package's cell draws as cell_ids/positions."""
        mcfg = self.model_config
        gcfg = mcfg.grid
        if cell_ids is None:
            cell_ids, positions = occ_lib.sample_update_positions(
                self._gen, gcfg, occ_lib.num_update_cells(gcfg), self.device
            )
        flat = positions.reshape(-1, 3)
        field_params = self.params["model"]["field"]
        dens = torch.cat([
            field_lib.density_fn(field_params, flat[i : i + OCC_CHUNK], mcfg.field)[:, 0]
            for i in range(0, flat.shape[0], OCC_CHUNK)
        ])
        step_size = mcfg.march_config().render_step_size
        self.occ = occ_lib.sampled_update(
            self.occ, cell_ids, dens.reshape(cell_ids.shape) * step_size, gcfg
        )


def _as_leaves(tree: dict, device) -> dict:
    """Copy of a nested dict with every tensor a fresh f32 leaf on device."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _as_leaves(v, device)
        else:
            out[k] = torch.as_tensor(v, dtype=torch.float32).detach().to(device).clone().requires_grad_(True)
    return out
