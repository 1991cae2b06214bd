"""The port's train step written out plainly: the bundles, the one volume
render of all bundles, the losses, the backward and Adam, and the
occupancy update, as the port's `engine/trainer.py` and the body of
`engine/chunk_graph.py` run them, on the frozen plain modules.

The parameters and the scene come from the caller; the grid's jitter,
the occupancy draws (seed + 1) and the random background (seed + 2) come
from generators on the run's device, seeded as the port seeds its own.
Adam is the textbook update (betas 0.9 / 0.999, eps 1e-15) in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from perfbench.frozen.ref.cameras import cameras as cam_lib
from perfbench.frozen.ref.cameras import pose_opt
from perfbench.frozen.ref.models import field as field_lib
from perfbench.frozen.ref.models import lsenerf as model_lib
from perfbench.frozen.ref.ops import interp
from perfbench.frozen.ref.ops import occupancy as occ_lib
from perfbench.frozen.ref.schedules import exponential_decay

OCC_CHUNK = 131072  # positions per density chunk of the occupancy update
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-15


@dataclass
class CamOpt:
    mode: str = "SO3xR3"  # off | SO3xR3 | SE3
    optim_type: str = "ns"  # ns | spline | prevnext
    exp_t: float = 30000.0
    control_pnt_factor: int = 1


@dataclass
class Setting:
    """What the step needs besides the parameters: the two cameras'
    optimizers, the two Adam groups' schedules (lr, lr_final, max_steps)
    and the rays a step of each stream (0 where a stream is absent)."""

    col_cam_opt: CamOpt
    evs_cam_opt: CamOpt
    fields_lr: tuple = (1e-2, 1e-4, 200000)
    camera_lr: tuple = (1e-3, 1e-4, 5000)
    n_col: int = 0
    n_evs: int = 0


def tree_leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from tree_leaves(v, path)
        else:
            yield path, v


class Step:
    """One trainer's state on the frozen plain path: cameras, parameters,
    grid, generators and Adam's moments."""

    def __init__(self, setting: Setting, model_config, col_cams, evs=None, all_cameras=None,
                 num_embd: int = 1, device="cuda"):
        """`col_cams`: the train RGB cameras; `evs`: (prev cameras, next
        cameras) of the event frames, or None; `all_cameras`: the
        trajectory the spline's knots sit on (default the train cameras)."""
        self.s = setting
        self.mcfg = model_config.normalized()
        self.device = torch.device(device)
        self.num_embd = num_embd
        self.col_cams = col_cams.to(self.device)
        self.rgb_ts = self.col_cams.times
        self.prev_cams = self.next_cams = None
        if evs is not None:
            self.prev_cams, self.next_cams = (c.to(self.device) for c in evs)
        self.spline_params = self.spline_static = None
        if setting.col_cam_opt.optim_type == "spline":
            cams = all_cameras if all_cameras is not None else col_cams
            c2w = cams.camera_to_worlds.cpu().numpy()
            bottom = np.broadcast_to(np.array([[[0.0, 0, 0, 1]]], np.float32), (len(cams), 1, 4))
            self.spline_params, self.spline_static = pose_opt.init_spline(
                np.concatenate([c2w, bottom], axis=1), cams.times.cpu().numpy(),
                control_pnt_factor=setting.col_cam_opt.control_pnt_factor, dM=None,
                exp_t=setting.col_cam_opt.exp_t, device=self.device)
        self.params = None
        self.occ = None
        self.count = 0
        self.moments = {}

    # -- parameters ------------------------------------------------------------

    def init_params(self, generator: torch.Generator) -> dict:
        """The parameter tree the port's Trainer.init_params draws from
        `generator`: the model, then the cameras' parameters."""
        model = model_lib.init_model(generator, self.mcfg, num_imgs=self.num_embd,
                                     device=self.device)
        cam = {"col": {}, "evs": {}}
        cc, ec = self.s.col_cam_opt, self.s.evs_cam_opt
        if cc.optim_type == "spline":
            cam["col"] = {k: v.clone() for k, v in self.spline_params.items()}
        elif cc.mode != "off":
            cam["col"] = pose_opt.init_pose_deltas(len(self.col_cams), self.device)
        if self.prev_cams is not None:
            cam["evs"] = pose_opt.init_prevnext_deltas(len(self.prev_cams), self.device)
        return {"model": model, "camera_opt": cam}

    def start(self, params: dict, seed: int) -> None:
        """Fresh f32 leaves of `params`, the optimistic grid, the generators."""
        def leaves(tree):
            return {k: leaves(v) if isinstance(v, dict) else
                    v.detach().to(self.device, torch.float32).clone().requires_grad_(True)
                    for k, v in tree.items()}

        self.params = leaves(params)
        self.occ = occ_lib.init_occ_grid(self.mcfg.grid, self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.bg_gen = torch.Generator(device=self.device).manual_seed(seed + 2)
        self.count = 0
        self.moments = {}

    # -- the occupancy update --------------------------------------------------

    @torch.no_grad()
    def occ_update(self) -> None:
        gcfg = self.mcfg.grid
        cell_ids, positions = occ_lib.sample_update_positions(
            self.gen, gcfg, occ_lib.num_update_cells(gcfg), self.device)
        flat = positions.reshape(-1, 3)
        step_size = self.mcfg.march_config().render_step_size
        dens = torch.empty((flat.shape[0],), device=flat.device)
        for i in range(0, flat.shape[0], OCC_CHUNK):
            j = min(i + OCC_CHUNK, flat.shape[0])
            dens[i:j] = field_lib.density_fn(self.params["model"]["field"], flat[i:j],
                                             self.mcfg.field)[:, 0] * step_size
        occs = occ_lib.scatter_update(self.occ.occs, cell_ids, dens.reshape(cell_ids.shape), gcfg)
        self.occ = occ_lib.OccGridState(occs=occs, binaries=occ_lib.binarize(occs, gcfg))

    # -- bundles -----------------------------------------------------------------

    def _col_bundle(self, cam_params, batch):
        cfg = self.s.col_cam_opt
        cams = self.col_cams
        idx = batch["col_indices"][:, 0]
        coords = batch["col_indices"][:, 1:].float()
        deblur = self.mcfg.rgb_loss_type == "deblur"
        idx_r, coords_r = ((idx.repeat_interleave(4), coords.repeat_interleave(4, dim=0))
                           if deblur else (idx, coords))
        if cfg.optim_type == "spline":
            times = cams.times[idx]
            if deblur:
                c2w = pose_opt.spline_deblur_c2w(cam_params["col"], self.spline_static,
                                                 times[:, None], 1.0)
            else:
                c2w = pose_opt.spline_rgb_c2w(cam_params["col"], self.spline_static, times, 1.0)
            bundle = cam_lib.generate_rays(cams, idx_r, coords_r, c2w=c2w)
        else:
            bundle = cam_lib.generate_rays(cams, idx_r, coords_r)
            if cfg.mode != "off":
                bundle = pose_opt.apply_pose_deltas_to_bundle(cam_params["col"], bundle, 1.0,
                                                              cfg.mode)
        app = batch["col_app_id"]
        if deblur:
            delta = torch.arange(4, device=app.device) - 2
            app = torch.clamp(app[:, None] + delta[None], 0, self.num_embd - 1).reshape(-1)
        return bundle.replace(metadata={"appearance_id": app})

    def _evs_bundles(self, cam_params, batch):
        cfg = self.s.evs_cam_opt
        idx = batch["evs_indices"][:, 0]
        coords = batch["evs_indices"][:, 1:].float()
        prev = cam_lib.generate_rays(self.prev_cams, idx, coords)
        nxt = cam_lib.generate_rays(self.next_cams, idx, coords)
        if cfg.mode != "off":
            prev, nxt = pose_opt.apply_prevnext_to_bundles(cam_params["evs"], prev, nxt, 1.0,
                                                           cfg.mode)
        out = []
        for b in (prev, nxt):
            b = b.replace(metadata={"appearance_id": batch["evs_app_id"]})
            if b.times is not None:
                fixed = interp.find_closest_idxs(self.rgb_ts, b.times[:, 0])
                b = b.replace(camera_indices=fixed[:, None].int())
            out.append(b)
        return out

    def num_rays(self) -> int:
        deblur = self.mcfg.rgb_loss_type == "deblur"
        return self.s.n_col * (4 if deblur else 1) + 2 * self.s.n_evs

    # -- the step ----------------------------------------------------------------

    def loss(self, batch: dict, bg: Optional[torch.Tensor]):
        """The step's loss at the current parameters and grid."""
        mcfg, params = self.mcfg, self.params
        bundles, col_b, evs_b = [], None, None
        if self.s.n_col:
            bundles.append(self._col_bundle(params["camera_opt"], batch))
            col_b = {"image": batch["col_rgb"]}
        if self.s.n_evs:
            bundles += self._evs_bundles(params["camera_opt"], batch)
            evs_b = {"image": batch["evs_values"], "e_thresh": batch["e_thresh"]}
        sizes = [len(b) for b in bundles]
        big = model_lib.concat_bundles(bundles) if len(bundles) > 1 else bundles[0]
        raw = model_lib.render_bundle(params["model"], big, self.occ, mcfg, train=True, bg_color=bg)
        raw.pop("grad_overflow", None)
        offs = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        col_out = prev_out = next_out = None
        cursor = 0
        if self.s.n_col:
            col_out = model_lib.postprocess_outputs(
                params["model"], model_lib.slice_outputs(raw, offs[0], offs[1]), mcfg,
                train=True, ev_out=False)
            cursor = 1
        if self.s.n_evs:
            ev = [model_lib.postprocess_outputs(
                params["model"], model_lib.slice_outputs(raw, offs[j], offs[j + 1]), mcfg,
                train=True, ev_out=True) for j in range(cursor, len(bundles))]
            prev_out, next_out = ev[0], ev[-1]
        losses = model_lib.compute_losses(params["model"], mcfg, col_out, prev_out, next_out,
                                          col_b, evs_b)
        return sum(losses.values()), raw

    def step(self, batch: dict) -> dict:
        """One train step on a batch of device tensors: the background
        draw, the loss, its gradients and Adam at the step's learning
        rates. Returns {"loss": float, "grads": {path: gradient or None}}."""
        bg = None
        if self.mcfg.background_color == "random":
            bg = torch.rand((self.num_rays(), 3), generator=self.bg_gen, device=self.device)
        leaves = list(tree_leaves(self.params))
        for _, t in leaves:
            t.grad = None
        loss, _ = self.loss(batch, bg)
        loss.backward()
        grads = {p: (None if t.grad is None else t.grad.detach().clone()) for p, t in leaves}
        self._adam(leaves)
        self.count += 1
        return {"loss": float(loss.detach()), "grads": grads}

    @torch.no_grad()
    def _adam(self, leaves) -> None:
        b1, b2 = BETAS
        t = self.count + 1
        scheds = {"model": exponential_decay(*self.s.fields_lr),
                  "camera_opt": exponential_decay(*self.s.camera_lr)}
        for path, p in leaves:
            if p.grad is None:
                continue
            lr = scheds[path.split("/", 1)[0]](self.count)
            m, v = self.moments.get(path, (torch.zeros_like(p), torch.zeros_like(p)))
            g = p.grad
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            m_hat = m / (1 - b1 ** t)
            v_hat = v / (1 - b2 ** t)
            p -= lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
            self.moments[path] = (m, v)

    # -- eval renders --------------------------------------------------------------

    @torch.no_grad()
    def render_view(self, model_params: dict, occ, cams, cam_idx: int, appearance_id: int,
                    chunk: int = 4096, watch=None) -> torch.Tensor:
        """One full view's rgb (h, w, 3) on the device, in chunks of
        `chunk` rays, as the port's renderer does in eval mode (mapping on:
        the raw sum; else the background blended by the accumulation, random
        colours from a generator seeded 0, and clipped). `watch(bundle,
        out)` sees each chunk's rays and outputs."""
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(0)
        h, w = cams.height, cams.width
        ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                                indexing="ij")
        coords = torch.stack([ys.reshape(-1), xs.reshape(-1)], 1).float()
        outs = []
        for i in range(0, coords.shape[0], chunk):
            m = min(chunk, coords.shape[0] - i)
            idx = torch.full((m,), int(cam_idx), dtype=torch.long, device=dev)
            app = torch.full((m,), int(appearance_id), dtype=torch.long, device=dev)
            bundle = cam_lib.generate_rays(cams, idx, coords[i:i + m])
            bundle = bundle.replace(metadata={"appearance_id": app})
            out = model_lib.model_forward(model_params, bundle, occ, self.mcfg, train=False)
            rgb = out["rgb"]
            bgc = self.mcfg.background_color
            if bgc != "linear" and not self.mcfg.use_mapping:
                acc = out["accumulation"]
                if bgc == "white":
                    rgb = rgb + (1.0 - acc)
                elif bgc == "random":
                    rgb = rgb + torch.rand(rgb.shape, generator=gen, device=dev) * (1.0 - acc)
                rgb = torch.clamp(rgb, 0.0, 1.0)
            outs.append(rgb.float())
            if watch is not None:
                watch(bundle, out)
        return torch.cat(outs).reshape(h, w, 3)
