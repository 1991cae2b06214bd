"""Trainer: parameters, the three-bundle train step, Adam in two groups and
the occupancy-grid cadence. Port of lsenerf_tpu/engine/trainer.py: the
camera optimizers `ns` (SO3xR3 or SE3 deltas), `spline` (the RGB spline,
with deblur's 4 exposure poses, and the event cameras on it through dM)
and `prevnext` (explicit prev/next event cameras, detected from the
dataset), and deblur with any of them; the run modes, which freeze
parameter groups (EVAL the field, PRETRAIN all but the test embedding,
RENDER everything); the eval-ray-batch loss; the state a checkpoint
holds; and data parallelism over ranks (`dp`, parallel/ddp.py): the
gradients averaged over the ranks before Adam, the occupancy sweep
sharded over them.

`Trainer.step(batch)` is the public entry. PyTorch runs eagerly, so there
is no jitted step: the step is the forward, `backward()` and the optimizer
update, on `self.device`. `Trainer.make_train_step_multi(k)` takes k
steps a call (JAX's lax.scan over stacked batches): on the card one
replayed CUDA graph (engine/chunk_graph.py), on the CPU k eager steps.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field as dc_field, replace
from typing import Optional

import numpy as np
import torch

from lsenerf_tpu_torch import resolve_device
from lsenerf_tpu_torch.cameras import cameras as cam_lib
from lsenerf_tpu_torch.cameras import pose_opt
from lsenerf_tpu_torch.data.datamanager import MultiCamDataManager
from lsenerf_tpu_torch.engine import spans
from lsenerf_tpu_torch.engine.schedules import exponential_decay
from lsenerf_tpu_torch.models import field as field_lib
from lsenerf_tpu_torch.models import lsenerf as model_lib
from lsenerf_tpu_torch.ops import bundles
from lsenerf_tpu_torch.ops import occupancy as occ_lib

OCC_CHUNK = 131072  # positions per density chunk of the occupancy update


class RunMode:
    """What a run trains: the reference's IS_EVAL / DO_PRETRAIN / IS_RENDER."""

    TRAIN = "train"
    EVAL = "eval"  # frozen field, camera-opt-only refinement
    PRETRAIN = "pretrain"  # the test embedding alone (emb_eval stage 1)
    RENDER = "render"  # nothing trains


@dataclass
class OptimizerGroupConfig:
    lr: float = 1e-2
    eps: float = 1e-15
    lr_final: float = 1e-4
    max_steps: int = 200000
    warmup_steps: int = 0


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
    max_num_iterations: int = 30000
    steps_per_save: int = 2000
    steps_per_eval_batch: int = 500
    steps_per_eval_image: int = 500
    steps_per_eval_all_images: int = 25000
    seed: int = 42
    mode: str = RunMode.TRAIN
    # the training loop's grad_overflow sentinel: every N steps, on the
    # blocked layout in TRAIN mode, overflow_count of the step's batch
    # (JAX's make_overflow_probe); 0 turns it off
    grad_overflow_every: int = 256
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


def trainable(mode: str, path: str) -> bool:
    """Does a leaf (its path in the parameter tree) train in this run
    mode? EVAL freezes the model, PRETRAIN trains only the test embedding,
    RENDER nothing."""
    if path.startswith("model/"):
        if mode == RunMode.PRETRAIN:
            return "test_table" in path
        return mode == RunMode.TRAIN
    return mode in (RunMode.TRAIN, RunMode.EVAL)


def build_optimizer(config: TrainerConfig, params: dict):
    """Adam over two groups, "fields" (params['model']) and "camera_opt"
    (params['camera_opt']), eps 1e-15, each with its exponential decay,
    holding only the leaves the run mode trains: a frozen leaf is in no
    group, so it stays as it is bit for bit (the reference deletes frozen
    groups; the JAX package zeroes their updates). Returns (optimizer,
    per-group schedules, per-group leaf paths), the optimizer None where
    nothing trains; the caller sets each group's lr to schedule(count)
    before the update (write_lrs), count = updates this optimizer has made,
    the count optax passes to its schedule. The update is torch's fused
    one, one pass over each leaf's parameter, gradient and moments, on the
    card and on the CPU alike; a trained leaf has to be a dense float
    tensor (ValueError names one that is not). On CUDA the optimizer is
    also capturable, with each group's lr a device tensor, so that a CUDA
    graph can hold its steps; eager steps there take the same arithmetic."""
    groups, schedules, paths = [], [], []
    capturable = False
    for name, g in (("model", config.fields_optimizer), ("camera_opt", config.camera_optimizer)):
        leaves = [(p, t) for p, t in tree_leaves(params[name], name) if trainable(config.mode, p)]
        if not leaves:
            continue
        for p, t in leaves:
            if not (t.is_floating_point() and t.is_contiguous()):
                raise ValueError(f"Adam's fused update takes dense float leaves; {p} is a "
                                 f"{t.dtype} tensor of strides {t.stride()} and shape "
                                 f"{tuple(t.shape)}: make it contiguous where it is created")
        capturable = leaves[0][1].is_cuda
        lr = torch.tensor(g.lr, dtype=torch.float32, device=leaves[0][1].device) if capturable else g.lr
        groups.append({"params": [t for _, t in leaves], "lr": lr, "eps": g.eps, "name": name})
        schedules.append(exponential_decay(g.lr, g.lr_final, g.max_steps, g.warmup_steps))
        paths.append([p for p, _ in leaves])
    optimizer = None
    if groups:
        optimizer = torch.optim.Adam(groups, betas=(0.9, 0.999), capturable=capturable, fused=True)
        # eager steps of a capturable Adam are meant here: no warning for them
        optimizer._warned_capturable_if_run_uncaptured = True
    return optimizer, schedules, paths


def write_lrs(optimizer, lrs) -> None:
    """Each group's lr to its entry of `lrs`, a float or a 0-dim device
    value: written into the group's device tensor where the optimizer is
    capturable, else set as a float."""
    for group, lr in zip(optimizer.param_groups, lrs):
        if not isinstance(group["lr"], torch.Tensor):
            group["lr"] = float(lr)
        elif isinstance(lr, torch.Tensor):
            group["lr"].copy_(lr)
        else:
            group["lr"].fill_(lr)


def set_lrs(optimizer, schedules, count: int) -> None:
    """Each group's lr to its schedule at `count` (write_lrs)."""
    write_lrs(optimizer, [sched(count) for sched in schedules])


class Trainer:
    """Owns the data manager, configs, parameters, optimizer and grid."""

    def __init__(self, config: TrainerConfig, model_config: model_lib.ModelConfig,
                 dm: MultiCamDataManager, device=None, all_cameras=None, dp=None):
        """`all_cameras`: the full RGB trajectory the spline's knots are
        placed on, where the train split is only part of it; by default
        the train cameras. `dp`: this process's rank (a
        parallel.ddp.DataParallel), None for a single process; the data
        manager then samples this rank's share."""
        self.model_config = model_config.normalized()
        self.dm = dm
        self.dp = dp
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
        self._chunks = {}  # k -> engine.chunk_graph.ChunkGraph
        self._recapture = None  # why the graphs were last dropped, where they were
        self.chunk_losses = None  # each step's loss of the last chunk
        self._eager_note = False
        self._part_cache = {}  # (deblur, denerf) -> the step's bundles (_parts)

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
        if self.dp is not None:
            self.dp.broadcast_([t for _, t in tree_leaves(self.params)])
        self.rebuild_optimizer()
        # the occupancy draws (the same on every rank) and this rank's
        # random background colours
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._bg_gen = torch.Generator(device=self.device).manual_seed(seed + 2 + self.rank)
        self.step_count = 0

    @contextlib.contextmanager
    def model_override(self, **fields):
        """The model config with `fields` replaced for the duration (the
        proposal warmup's proposal_samples=0); the parameters, Adam's state
        and the grid carry over, since none depends on them."""
        saved = self.model_config
        self.model_config = replace(saved, **fields)
        try:
            yield self
        finally:
            self.model_config = saved

    @property
    def rank(self) -> int:
        return 0 if self.dp is None else self.dp.rank

    def rng_state(self) -> dict:
        """The generators' states for a checkpoint: {"occ": the occupancy
        draws', "bg": (ranks, n) every rank's background generator}. Under
        data parallelism every rank calls it (it gathers)."""
        bg = self._bg_gen.get_state()
        bgs = [bg] if self.dp is None else self.dp.all_gather_object(bg)
        return {"occ": self._gen.get_state(), "bg": torch.stack(bgs)}

    def set_rng_state(self, rng) -> None:
        """rng_state()'s generators, each rank its own background row
        (a rank the checkpoint has no row for keeps its fresh one). A
        checkpoint written before the background had its own generator
        holds one state tensor, which served both streams: both resume
        from it."""
        if isinstance(rng, torch.Tensor):
            rng = {"occ": rng, "bg": rng[None]}
        self.invalidate_graphs("set_rng_state")
        self._gen.set_state(rng["occ"])
        if self.rank < rng["bg"].shape[0]:
            self._bg_gen.set_state(rng["bg"][self.rank].clone())

    def rebuild_optimizer(self) -> None:
        """A fresh optimizer (no moments, count 0) over the current leaves,
        as after a change to the tree (the test embedding's graft)."""
        self.invalidate_graphs("new optimizer")
        self.optimizer, self.schedules, self.opt_paths = build_optimizer(self.config, self.params)
        self.opt_count = 0

    def invalidate_graphs(self, reason: str) -> None:
        """Drop the chunks' CUDA graphs: something they read was replaced
        (`reason`: the optimizer, Adam's state in a restore, a generator's
        state); the next chunk of each k warms up and captures anew, the
        capture counted under the last such reason. A graph of another
        model config (model_override, a replaced grid config) is replaced
        at its next chunk (train_chunk)."""
        if self._chunks or self._recapture:
            self._recapture = reason
        self._chunks.clear()

    # -- bundles -------------------------------------------------------------

    def _parts(self) -> tuple:
        """The bundles one step renders as ops.bundles.Part, in order: the
        RGB rays (under deblur 4 a pixel, on the spline's exposure poses or
        on the pixel's one pose) and the prev and next event rays (the
        dataset's prev_cameras[i] and next_cameras[i] where it has them,
        else cameras i and i + 1, on the spline through dM when the event
        cameras use it; no next under denerf), for the current model
        config."""
        key = (self.model_config.rgb_loss_type == "deblur", self._denerf())
        parts = self._part_cache.get(key)
        if parts is None:
            parts = self._part_cache[key] = self._make_parts(*key)
        return parts

    def _make_parts(self, deblur: bool, denerf: bool) -> tuple:
        cc, ec = self.config.col_cam_opt, self.config.evs_cam_opt
        has_col, has_evs = self._has()
        parts = []
        if has_col:
            if cc.optim_type == "spline":
                pose, table = bundles.SPLINE, ("col",)
            elif cc.mode != "off":
                pose, table = bundles.DELTA_POSES[cc.mode], ("col",)
            else:
                pose, table = bundles.FIXED, ()
            parts.append(bundles.Part(self.col_cams, pose, "col_indices", "col_app_id",
                                      rep=4 if deblur else 1, table=table, gate=0,
                                      app_deblur=deblur))
        if has_evs:
            # CameraIdxFixer: event times snap to the nearest RGB camera
            ev = dict(rows="evs_indices", app="evs_app_id", gate=1, snap=self.rgb_ts is not None)
            if self.prev_cams is not None:
                deltas = ec.optim_type == "prevnext" and ec.mode != "off"
                pose = bundles.DELTA_POSES[ec.mode] if deltas else bundles.FIXED
                pair = [bundles.Part(cams, pose, table=("evs", sub) if deltas else (), **ev)
                        for cams, sub in ((self.prev_cams, "prev"), (self.next_cams, "next"))]
            elif ec.optim_type == "spline":
                pair = [bundles.Part(self.evs_cams, bundles.SPLINE_EVS, cam_offset=off,
                                     table=("col",), **ev) for off in (0, 1)]
            else:
                deltas = ec.mode != "off"
                pose = bundles.DELTA_POSES[ec.mode] if deltas else bundles.FIXED
                pair = [bundles.Part(self.evs_cams, pose, cam_offset=off,
                                     table=("evs",) if deltas else (), **ev) for off in (0, 1)]
            parts += pair[:1] if denerf else pair
        return tuple(parts)

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
        if spans.tracing():
            spans.count("staged_bytes", sum(v.numel() * v.element_size() for v in out.values()))
        return out

    def _denerf(self) -> bool:
        """The denerf shortcut: the next event bundle is not rendered and
        the event loss reads the prev bundle's output twice."""
        return "denerf" in self.model_config.event_loss_type

    def bundle_sizes(self, batch: dict) -> list:
        """Rays of each bundle one step renders for this batch, in the
        order of the background's rows: RGB, prev and next event rays."""
        has_col, has_evs = self._has()
        sizes = []
        if has_col:
            sizes.append(len(batch["col_indices"]) * (4 if self.model_config.rgb_loss_type == "deblur" else 1))
        if has_evs:
            sizes += [len(batch["evs_indices"])] * (1 if self._denerf() else 2)
        return sizes

    def num_rays(self, batch: dict) -> int:
        """Rays one step renders for this batch (the background's rows)."""
        return sum(self.bundle_sizes(batch))

    def _step_bundles(self, cam_params: dict, batch: dict, step: int, gates=None):
        """The rays one step renders as one bundle (its bundles, _parts,
        concatenated in order by ops.bundles.step_rays: K8a/K8b on the
        card), the rays of each, and the RGB and event targets (None where
        the batch has no such rays). The cameras' delayed-activation gates
        are step's, or `gates` (RGB, event), device values a CUDA graph
        reads at each replay."""
        tcfg = self.config
        has_col, has_evs = self._has()
        if gates is None:
            gates = (pose_opt.activation_gate(step, tcfg.col_cam_opt.scheme, tcfg.col_cam_opt.delay_cnt),
                     pose_opt.activation_gate(step, tcfg.evs_cam_opt.scheme, tcfg.evs_cam_opt.delay_cnt))
        col_batch = {"image": batch["col_rgb"]} if has_col else None
        evs_batch = {"image": batch["evs_values"], "e_thresh": batch["e_thresh"]} if has_evs else None
        big, sizes = bundles.step_rays(self._parts(), cam_params, batch, gates,
                                       self.col_spline_static, self.rgb_ts, self.dm.num_embd)
        return big, sizes, col_batch, evs_batch

    def loss_fn(self, params: dict, occ, batch: dict, step: int, bg_color=None, gates=None):
        """(params, occ, batch, step, background) -> (loss, metrics): one
        volume render for all bundles (RGB, prev and next event; no next
        under denerf), split and post-processed per branch. `gates`, where
        given, stands for step's camera gates (_step_bundles)."""
        mcfg = self.model_config
        has_col, has_evs = self._has()
        cam_params = params["camera_opt"]
        col_out = prev_out = next_out = None
        with spans.layer("bundles"):
            big, sizes, col_batch, evs_batch = self._step_bundles(cam_params, batch, step, gates)
        raw = model_lib.render_bundle(params["model"], big, occ, mcfg, train=True, bg_color=bg_color)
        overflow = raw.pop("grad_overflow", None)  # one count, not sliced by bundle
        offs = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        cursor = 0
        with spans.layer("losses"):
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
                    for j in range(cursor, len(sizes))
                ]
                prev_out, next_out = ev_outs[0], ev_outs[-1]
            loss_dict = model_lib.compute_losses(
                params["model"], mcfg, col_out, prev_out, next_out, col_batch, evs_batch,
                batch_sum=None if self.dp is None else self.dp.batch_sum,
            )
            total = sum(loss_dict.values())
        metrics = dict(loss_dict)
        if overflow is not None:
            metrics["grad_overflow"] = overflow.float()
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
        return torch.rand((n, 3), generator=self._bg_gen, device=self.device)

    def _loss_backward(self, batch: dict, bg_color=None, gates=None, occ=None):
        """The first half of an update: the background drawn where
        `bg_color` is None, the grads cleared, then one step's loss on
        `batch` at the current parameters and on grid `occ` (the
        trainer's by default) between two "other" marks, and its backward.
        Returns (loss, metrics)."""
        if bg_color is None:
            bg_color = self._draw_background(self.num_rays(batch))
        for _, t in tree_leaves(self.params):
            t.grad = None
        spans.mark("other")
        loss, metrics = self.loss_fn(self.params, self.occ if occ is None else occ, batch,
                                     self.step_count, bg_color, gates=gates)
        spans.mark("other")
        with spans.layer("backward"):
            loss.backward()
        return loss, metrics

    def grads(self, batch: dict, bg_color=None):
        """Loss, metrics and the gradients (a dict path -> tensor) of one
        step's loss at the current parameters; nothing is updated. A leaf
        outside this step's graph (the spline's scale when the event
        cameras are not on the spline, rgb_to_one when the event branch
        does not read it) gets zeros, as JAX gives it; its .grad stays
        None, so Adam leaves it as it is."""
        loss, metrics = self._loss_backward(batch, bg_color)
        grads = {p: torch.zeros_like(t) if t.grad is None else t.grad
                 for p, t in tree_leaves(self.params)}
        return loss, metrics, grads

    def update(self, batch: dict, bg_color=None, gates=None, lrs=None, occ=None):
        """One update on device-side inputs, the body of Trainer.step and
        of each step of a chunk's graph (engine/chunk_graph.py): the loss
        and its backward (_loss_backward; `gates`, where given, stand for
        the step's camera gates, as in loss_fn), under data parallelism the
        gradients and metrics averaged over the ranks (then an "other"
        mark), and Adam with each group's lr from `lrs` (floats or 0-dim
        device values; by default the schedules at opt_count). Counts
        nothing. Returns (loss, metrics)."""
        loss, metrics = self._loss_backward(batch, bg_color, gates, occ)
        if self.dp is not None:
            self.dp.average_grads([t.grad for _, t in tree_leaves(self.params) if t.grad is not None])
            metrics = self.dp.average_metrics(dict(metrics, loss=loss))
            loss = metrics.pop("loss")
            spans.mark("other")
        if self.optimizer is not None:
            with spans.layer("adam"):
                write_lrs(self.optimizer, [sched(self.opt_count) for sched in self.schedules]
                          if lrs is None else lrs)
                self.optimizer.step()
        return loss, metrics

    def step(self, batch: dict, bg_color=None, update_occ: bool = True) -> dict:
        """One training step on a data-manager batch (numpy or tensors;
        under data parallelism this rank's share). Runs the occupancy
        update first every `update_interval` steps where `update_occ`, as
        the JAX training loop does (a render run's loop does not). Returns
        detached metric tensors, under data parallelism the ranks' mean.
        On the card, while a profiler runs, the step is one group of device
        marks (engine/spans.py)."""
        marks = spans.open_marks(self.device, 1)
        if update_occ and self.step_count % self.model_config.grid.update_interval == 0:
            self.occ_update()
        loss, metrics = self.update(self.batch_to_device(batch), bg_color)
        if self.optimizer is not None:
            self.opt_count += 1
        self.step_count += 1
        metrics["loss"] = loss
        spans.count("steps")
        spans.close_marks(marks)
        return {k: v.detach() for k, v in metrics.items()}

    def make_train_step_multi(self, k: int):
        """k steps a call (JAX's make_train_step_multi): fn(stacked) with
        stacked a dict of (k, ...) arrays from
        MultiCamDataManager.next_train_stack. Returns the last step's
        metrics and advances step_count and opt_count by k; each step's
        loss is left in chunk_losses. No occupancy update runs inside a
        chunk: the training loop runs it before the chunk."""

        def train_steps(stacked: dict) -> dict:
            n = len(next(iter(stacked.values())))
            if n != k:
                raise ValueError(f"a chunk of {n} batches given to a {k}-step function")
            return self.train_chunk(stacked)

        return train_steps

    def _eager_chunk_reason(self) -> Optional[str]:
        """Why a chunk runs as k eager steps, or None: the CPU has no CUDA
        graphs, and on the card data parallelism (the gradient all-reduce
        runs on the host over gloo) and compact_chunk (one host sync a
        call) cannot be captured."""
        if self.device.type != "cuda":
            return "no CUDA device"
        if self.dp is not None:
            return "data parallelism averages the gradients on the host"
        if self.model_config.compact_chunk > 0:
            return "compact_chunk reads its live-chunk count on the host"
        return None

    def train_chunk(self, stacked: dict) -> dict:
        """One chunk of make_train_step_multi: where _eager_chunk_reason
        names a reason (said once on the card), k eager steps; else one CUDA
        graph (engine/chunk_graph.py)."""
        k = len(next(iter(stacked.values())))
        reason = self._eager_chunk_reason()
        if reason is not None:
            if self.device.type == "cuda" and not self._eager_note:
                print(f"[lsenerf-torch] scan_steps: each chunk runs as {k} eager steps ({reason})")
                self._eager_note = True
            spans.count("eager_steps", k, reason)
            out = [self.step({key: v[j] for key, v in stacked.items()}, update_occ=False)
                   for j in range(k)]
            self.chunk_losses = torch.stack([m["loss"] for m in out])
            return out[-1]
        from lsenerf_tpu_torch.engine.chunk_graph import ChunkGraph

        cg = self._chunks.get(k)
        if cg is None or cg.model_config is not self.model_config:
            cause = "model config" if cg is not None else (self._recapture or "first")
            self._recapture = None
            cg = self._chunks[k] = ChunkGraph(self, k, stacked, cause)
        metrics, self.chunk_losses = cg.run(stacked)
        if self.optimizer is not None:
            self.opt_count += k
        self.step_count += k
        spans.count("steps", k)
        return metrics

    @torch.no_grad()
    def eval_batch(self, cameras: cam_lib.Cameras, idx, coords, gt, app_id) -> dict:
        """The eval-ray-batch loss: rays of the eval cameras at (idx,
        coords [y, x]) rendered in eval mode against gt; returns eval_loss
        (MSE) and eval_batch_psnr."""
        dev = self.device
        bundle = cam_lib.generate_rays(cameras, torch.as_tensor(idx, device=dev).long(),
                                       torch.as_tensor(coords, device=dev).float())
        bundle = bundle.replace(metadata={"appearance_id": torch.as_tensor(app_id, device=dev).long()})
        out = model_lib.model_forward(self.params["model"], bundle, self.occ, self.model_config,
                                      train=False)
        mse = ((out["rgb"] - torch.as_tensor(gt, device=dev).float()) ** 2).mean()
        return {"eval_loss": mse, "eval_batch_psnr": -10.0 * torch.log10(mse)}

    @torch.no_grad()
    def overflow_count(self, batch: dict) -> Optional[torch.Tensor]:
        """The grad_overflow sentinel's probe (JAX's make_overflow_probe):
        the step's bundles for `batch` at the current parameters and step,
        marched, and the table-gradient updates JAX's sorted windowed
        backward would drop for their samples (model_lib.overflow_count);
        None on the ngp layout, which has no such backward."""
        mcfg = self.model_config
        if mcfg.field.hash.layout != "blocked":
            return None
        from lsenerf_tpu_torch.ops import march

        big, _, _, _ = self._step_bundles(self.params["camera_opt"], self.batch_to_device(batch),
                                          self.step_count)
        samples = march.march_rays(big, self.occ, mcfg.grid, mcfg.march_config())
        return model_lib.overflow_count(samples.positions.reshape(-1, 3), mcfg)

    # -- checkpoint state -----------------------------------------------------

    def adam_state(self) -> dict:
        """{leaf path: {exp_avg, exp_avg_sq, step}} of the leaves Adam has
        stepped, on the CPU."""
        out = {}
        if self.optimizer is None:
            return out
        for group, paths in zip(self.optimizer.param_groups, self.opt_paths):
            for p, t in zip(paths, group["params"]):
                st = self.optimizer.state.get(t)
                if st:
                    out[p] = {k: torch.as_tensor(v).detach().cpu().clone() for k, v in st.items()}
        return out

    def load_adam_state(self, adam: dict, count: int) -> bool:
        """Adam's moments from adam_state(), where they fit this optimizer
        (the same trained leaves, the same shapes); else it stays fresh.
        Returns whether they were loaded."""
        if self.optimizer is None:
            return not adam
        leaves = {p: t for group, paths in zip(self.optimizer.param_groups, self.opt_paths)
                  for p, t in zip(paths, group["params"])}
        if set(adam) - set(leaves) or any(
                adam[p]["exp_avg"].shape != leaves[p].shape for p in adam):
            return False
        # the fused Adam reads each leaf's step count on the leaf's device, in
        # f32; a checkpoint may hold it on the CPU or in f64
        self.invalidate_graphs("restore")
        for p, st in adam.items():
            t = leaves[p]
            self.optimizer.state[t] = {
                k: v.to(t.device, torch.float32, copy=True) if k == "step" else v.to(t.device)
                for k, v in st.items()}
        self.opt_count = int(count)
        return True

    # -- loop ----------------------------------------------------------------

    def train(self, num_steps: Optional[int] = None, log_every: int = 100, callback=None,
              **loop_kwargs) -> dict:
        """The library's entry point (lsenerf_tpu/engine/trainer.py::
        Trainer.train): an alias of engine.loop.run_training_loop, the loop
        the CLI runs. Other keyword arguments (scan_steps, eval_ds,
        ckpt_dir, print_every, fail_fast, ...) go to the loop. Returns the
        last step's metrics; the state stays on the trainer."""
        from lsenerf_tpu_torch.engine.loop import run_training_loop

        return run_training_loop(self, num_steps=num_steps, log_every=log_every,
                                 callback=callback, **loop_kwargs)

    # -- occupancy maintenance ------------------------------------------------

    @torch.no_grad()
    def occ_update(self, cell_ids=None, positions=None) -> None:
        """Sampled EMA update: densities at random jittered cells of every
        level, evaluated in chunks of OCC_CHUNK positions. The tests pass
        the JAX package's cell draws as cell_ids/positions. Under data
        parallelism every rank draws the same cells and evaluates its share
        of them; the others' are -inf, which the max-scatter leaves as the
        decayed grid, and an all-reduce MAX of the ranks' grids makes the
        whole update, the same on every rank."""
        marks = spans.open_marks(self.device, 0)
        with spans.layer("occupancy update"):
            mcfg = self.model_config
            gcfg = mcfg.grid
            if cell_ids is None:
                cell_ids, positions = occ_lib.sample_update_positions(
                    self._gen, gcfg, occ_lib.num_update_cells(gcfg), self.device
                )
            flat = positions.reshape(-1, 3)
            lo, hi = (0, flat.shape[0]) if self.dp is None else self.dp.share(flat.shape[0])
            field_params = self.params["model"]["field"]
            step_size = mcfg.march_config().render_step_size
            dens = torch.full((flat.shape[0],), float("-inf"), device=flat.device)
            for i in range(lo, hi, OCC_CHUNK):
                j = min(i + OCC_CHUNK, hi)
                dens[i:j] = field_lib.density_fn(field_params, flat[i:j], mcfg.field)[:, 0] * step_size
            occs = occ_lib.scatter_update(self.occ.occs, cell_ids, dens.reshape(cell_ids.shape), gcfg)
            if self.dp is not None:
                self.dp.max_(occs)
            self.occ = occ_lib.OccGridState(occs=occs, binaries=occ_lib.binarize(occs, gcfg))
        spans.count("occ_updates")
        spans.close_marks(marks)


def _as_leaves(tree: dict, device) -> dict:
    """Copy of a nested dict with every tensor a fresh f32 leaf on device."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _as_leaves(v, device)
        else:
            out[k] = torch.as_tensor(v, dtype=torch.float32).detach().to(device).clone().requires_grad_(True)
    return out
