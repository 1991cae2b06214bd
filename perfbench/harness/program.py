"""The system under test, the port `lsenerf_tpu_torch`, built from a
configuration file: its datasets over the benchmark's scene, its data
manager and Trainer as the CLI builds them (flagship.preset_configs is the
CLI's lowering of configs/<preset>.sh under train_lse_data.sh), with the
weights the benchmark drew from the seed, and the way back to that start
in place; and beside it the reference (`perfbench.frozen`) set up from the
same scene, weights and seed.

This is the one module of the harness that imports the port."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from perfbench.frozen import presets
from perfbench.frozen.ref.cameras.cameras import Cameras as RefCameras
from perfbench.frozen.ref.trainer import Step, tree_leaves
from perfbench.frozen.scene import Scene, make_scene


class Started:
    """A run's set-up before its traffic's warm-up: the scene, the
    reference, the seed's weights and the port's Trainer with them, and the
    seconds since the process started at the end of each part. The
    reference's own seconds (`ref_s`: building its step, whose spline the
    weights' draw needs) are no part of set-up."""

    def __init__(self, ctx):
        cfg, dev = ctx.config, ctx.device
        self.marks = [("start", time.perf_counter() - ctx.t0)]
        self.compile_s = build_kernels(dev)
        self.mark(ctx, "kernels")
        self.scene = scene_for(cfg, dev)
        self.mark(ctx, "scene")
        r0 = time.perf_counter()
        self.ref = reference(cfg, self.scene, dev)
        self.ref_s = time.perf_counter() - r0
        self.mark(ctx, "reference")
        self.params0 = draw_params(self.ref, ctx.seed)
        if dev.type == "cuda":
            # the peak is the job's: the scene's making on the card is not
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        self.trainer = trainer(cfg, self.scene, ctx.seed, self.params0, dev)
        self.mark(ctx, "trainer")

    def mark(self, ctx, name: str) -> float:
        at = time.perf_counter() - ctx.t0
        self.marks.append((name, at))
        return at

    def setup_s(self, ctx, name: str) -> float:
        """Set-up up to now, marked as `name`: the seconds since the process
        started less the reference's own."""
        return self.mark(ctx, name) - self.ref_s

    def parts(self) -> str:
        return ", ".join(f"{n} {v:.3f}" for n, v in self.marks)


def build_kernels(device) -> float:
    """Build every CUDA source of the port that has no library in the
    checkout yet (nvcc, all at once); seconds it took."""
    if device.type != "cuda":
        return 0.0
    from lsenerf_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all()
    return time.perf_counter() - t0


def scene_for(cfg: dict, device) -> Scene:
    s = cfg["scene"]
    return make_scene(s["n_cams"], s["h"], s["w"], s["focal"], s["texture_freq"], s["n_val"],
                      device=device)


def _cams(cls, c2ws, times, sc: Scene):
    return cls(camera_to_worlds=torch.from_numpy(np.ascontiguousarray(c2ws)), fx=sc.focal,
               fy=sc.focal, cx=sc.w / 2.0, cy=sc.h / 2.0, width=sc.w, height=sc.h,
               times=torch.from_numpy(np.ascontiguousarray(times)))


def uses_events(cfg: dict) -> bool:
    return presets.PRESETS[cfg["preset"]][0] < 1.0


def reference(cfg: dict, sc: Scene, device) -> Step:
    """The reference's train step over the scene (no parameters yet)."""
    evs = None
    if uses_events(cfg):
        evs = (_cams(RefCameras, sc.prev_c2ws, sc.prev_times, sc),
               _cams(RefCameras, sc.next_c2ws, sc.next_times, sc))
    mcfg = presets.model_config(cfg["preset"], **cfg["field"])
    return Step(presets.setting(cfg["preset"], cfg["rays_per_batch"]), mcfg,
                _cams(RefCameras, sc.c2ws, sc.times, sc), evs,
                all_cameras=_cams(RefCameras, sc.full_c2ws, sc.full_times, sc),
                num_embd=num_embd(cfg, sc), device=device)


def num_embd(cfg: dict, sc: Scene) -> int:
    """Rows of the appearance table: the largest id of either stream + 1."""
    n = len(sc.images)
    if uses_events(cfg):
        n = max(n, len(sc.eimgs))
    return n


def draw_params(ref: Step, seed: int) -> dict:
    """The weights of a run: drawn on the device from the seed by the
    frozen init, in the tree the port's Trainer takes."""
    return ref.init_params(torch.Generator(device=ref.device).manual_seed(seed))


def trainer(cfg: dict, sc: Scene, seed: int, params: dict, device):
    """The port's Trainer on the scene, as the CLI's run() builds it from a
    parsed scene dir, set up with `params`."""
    from lsenerf_tpu_torch.cameras.cameras import Cameras
    from lsenerf_tpu_torch.data.datamanager import MultiCamDataManager
    from lsenerf_tpu_torch.data.dataset import ColorDataset, EventFrameDataset
    from lsenerf_tpu_torch.engine.trainer import Trainer
    from lsenerf_tpu_torch.flagship import preset_configs

    tcfg, mcfg, dmc = preset_configs(cfg["preset"], True, **cfg["field"])
    tcfg = dataclasses.replace(tcfg, seed=seed)
    dmc = dataclasses.replace(dmc, train_num_rays_per_batch=cfg["rays_per_batch"])
    n = len(sc.images)
    col = ColorDataset(images=sc.images, cameras=_cams(Cameras, sc.c2ws, sc.times, sc),
                       appearance_ids=np.arange(n, dtype=np.int32), data_idxs=list(range(n)))
    evs = None
    if uses_events(cfg):
        prev = _cams(Cameras, sc.prev_c2ws, sc.prev_times, sc)
        evs = EventFrameDataset(eimgs=sc.eimgs, cameras=prev, e_thresh=sc.e_thresh,
                                appearance_ids=np.arange(len(sc.eimgs), dtype=np.int32),
                                prev_cameras=prev,
                                next_cameras=_cams(Cameras, sc.next_c2ws, sc.next_times, sc))
    dm = MultiCamDataManager(dmc, col, evs, seed=seed)
    t = Trainer(tcfg, mcfg, dm, device=device,
                all_cameras=_cams(Cameras, sc.full_c2ws, sc.full_times, sc))
    t.setup(params=params)
    return t


def train_chunks(t, steps: int, scan_steps: int, callback=None) -> dict:
    """`steps` train steps through the CLI's loop (engine/loop.py), in
    chunks of scan_steps, with its default log and overflow cadences and
    no evals or checkpoints; `callback(step, scalars)` at each logged step,
    as the loop takes it. Returns the loop's last metrics."""
    from lsenerf_tpu_torch.engine.loop import run_training_loop

    return run_training_loop(t, num_steps=steps, scan_steps=scan_steps, callback=callback)


def start_of(t) -> dict:
    """What a freshly set-up Trainer holds besides its weights: its
    generators' states and its grid, copied, to go back to (restart)."""
    return {"gen": t._gen.get_state(), "bg": t._bg_gen.get_state(),
            "occs": t.occ.occs.detach().clone(), "binaries": t.occ.binaries.detach().clone()}


@torch.no_grad()
def restart(t, params0: dict, start: dict) -> None:
    """The Trainer back at its start, in place, so that the CUDA graph it
    captured (which holds its tensors) runs from there: the weights
    `params0` copied into its leaves, Adam's moments and counts at zero as a
    fresh Adam has them, the generators at their states of `start` (set in
    place, as the graph registered them), a new grid with the start's
    values, and step 0."""
    flat0 = dict(tree_leaves(params0))
    for path, leaf in tree_leaves(t.params):
        leaf.copy_(flat0[path])
    for state in t.optimizer.state.values():
        for v in state.values():
            if torch.is_tensor(v):
                v.zero_()
    t._gen.set_state(start["gen"])
    t._bg_gen.set_state(start["bg"])
    t.occ = type(t.occ)(occs=start["occs"].clone(), binaries=start["binaries"].clone())
    t.step_count = t.opt_count = 0
