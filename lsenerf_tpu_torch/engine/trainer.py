"""Trainer: parameters, the three-bundle train step, Adam in two groups and
the occupancy-grid cadence. Port of lsenerf_tpu/engine/trainer.py for the
flagship path: `ns` SO3xR3 camera deltas for both cameras and consecutive
event cameras. The spline and prev/next camera optimizers, the eval and
pretrain modes, and data parallelism are not ported yet.

`Trainer.step(batch)` is the public entry. PyTorch runs eagerly, so there
is no jitted step: the step is the forward, `backward()` and the optimizer
update, on `self.device`.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
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
    mode: str = "off"  # off | SO3xR3
    optim_type: str = "ns"
    scheme: str = "active"  # active | delayed
    delay_cnt: int = 10000

    def __post_init__(self):
        if self.optim_type != "ns":
            raise NotImplementedError(
                f"camera optim_type={self.optim_type!r}: only 'ns' is ported"
            )
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
                 dm: MultiCamDataManager, device=None):
        self.config = config
        self.model_config = model_config
        self.dm = dm
        self.device = resolve_device(device)
        self.col_cams = dm.col.cameras.to(self.device) if dm.col is not None else None
        self.evs_cams = dm.evs.cameras.to(self.device) if dm.evs is not None else None
        self.rgb_ts = self.col_cams.times if self.col_cams is not None else None
        self.params = None
        self.occ = None
        self.step_count = 0

    # -- init ----------------------------------------------------------------

    def init_params(self, generator: torch.Generator) -> dict:
        model = model_lib.init_model(generator, self.model_config, device=self.device)
        cam = {"col": {}, "evs": {}}
        if self.config.col_cam_opt.mode != "off" and self.dm.col is not None:
            cam["col"] = pose_opt.init_pose_deltas(len(self.dm.col.cameras), self.device)
        if self.config.evs_cam_opt.mode != "off" and self.dm.evs is not None:
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
        cfg = self.config.col_cam_opt
        idx = batch["col_indices"][:, 0]
        coords = batch["col_indices"][:, 1:].float()
        bundle = cam_lib.generate_rays(self.col_cams, idx, coords)
        if cfg.mode != "off":
            bundle = pose_opt.apply_pose_deltas_to_bundle(cam_params["col"], bundle, gate, cfg.mode)
        return bundle.replace(metadata={"appearance_id": batch["col_app_id"]})

    def _make_evs_bundles(self, cam_params, batch, gate):
        """Consecutive cameras: frame i spans cameras i and i+1."""
        cfg = self.config.evs_cam_opt
        idx = batch["evs_indices"][:, 0]
        coords = batch["evs_indices"][:, 1:].float()
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

    def num_rays(self, batch: dict) -> int:
        """Rays one step renders for this batch (the background's rows)."""
        has_col, has_evs = self._has()
        n = 0
        if has_col:
            n += len(batch["col_indices"])
        if has_evs:
            n += 2 * len(batch["evs_indices"])
        return n

    def loss_fn(self, params: dict, occ, batch: dict, step: int, bg_color=None):
        """(params, occ, batch, step, background) -> (loss, metrics): one
        volume render for all three bundles, split and post-processed per
        branch."""
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
        if has_evs:
            bundles.extend(self._make_evs_bundles(cam_params, batch, evs_gate))
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
            prev_out, next_out = (
                model_lib.postprocess_outputs(
                    params["model"], model_lib.slice_outputs(raw, offs[j], offs[j + 1]),
                    mcfg, train=True, ev_out=True,
                )
                for j in (cursor, cursor + 1)
            )
        loss_dict = model_lib.compute_losses(
            params["model"], mcfg, col_out, prev_out, next_out, col_batch, evs_batch
        )
        total = sum(loss_dict.values())
        metrics = dict(loss_dict)
        for name, cp in cam_params.items():
            if "pose_adjustment" in cp:
                pa = cp["pose_adjustment"]
                metrics[f"camera_opt_translation_{name}"] = torch.linalg.norm(pa[:, :3])
                metrics[f"camera_opt_rotation_{name}"] = torch.linalg.norm(pa[:, 3:])
        if col_out is not None:
            mse = ((col_out["rgb"] - col_batch["image"]) ** 2).mean()
            metrics["psnr"] = -10.0 * torch.log10(mse)
            metrics["num_samples_per_ray"] = col_out["num_samples_per_ray"].float().mean()
        return total, metrics

    def _draw_background(self, n: int) -> torch.Tensor:
        return torch.rand((n, 3), generator=self._gen, device=self.device)

    def grads(self, batch: dict, bg_color=None):
        """Loss, metrics and the gradients (a dict path -> tensor) of one
        step's loss at the current parameters; nothing is updated."""
        if bg_color is None:
            bg_color = self._draw_background(self.num_rays(batch))
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss_fn(self.params, self.occ, batch, self.step_count, bg_color)
        loss.backward()
        grads = {p: t.grad for p, t in tree_leaves(self.params)}
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
