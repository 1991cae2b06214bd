"""Checkpoint save and load with the reference's resume contract. Port of
lsenerf_tpu/engine/checkpoints.py:
  - saves named step-{step:09d} under <run>/checkpoints, step being the
    last completed step;
  - the latest step found by name (--load-dir);
  - --load-dir restores weights, occupancy grid and step; --load-checkpoint
    also Adam's moments and count and the generator the occupancy draws
    and the random background come from, an exact resume;
  - an eval run's load zeroes every camera_opt leaf, so poses refined in
    training never reach the eval.

The JAX package writes orbax checkpoints, which need JAX to read. A port
checkpoint is one file, `torch.save` of nested dicts of CPU tensors, ints
and floats (no pickled classes; `torch.load(weights_only=True)` reads it):
{"step", "params" (the parameter tree), "occ" {"occs", "binaries"},
"opt" {"count", "adam" {leaf path: {"exp_avg", "exp_avg_sq", "step"}}},
"rng" {"occ": the occupancy draws' generator state, "bg": (ranks, n) each
rank's background generator state}}. A checkpoint of the port before the
background had a generator of its own holds one state tensor under "rng";
it resumes too (Trainer.set_rng_state). Under data parallelism every rank
calls save_checkpoint (it gathers the ranks' generators), rank 0 writes,
and every rank resumes from the file.
"""

from __future__ import annotations

import os
import os.path as osp
import re
from typing import Optional

import torch

from lsenerf_tpu_torch.ops.occupancy import OccGridState

STEP_NAME = re.compile(r"step-(\d+)$")


def _cpu_tree(tree: dict) -> dict:
    return {k: _cpu_tree(v) if isinstance(v, dict) else v.detach().cpu().clone()
            for k, v in tree.items()}


def save_checkpoint(ckpt_dir: str, step: int, trainer) -> str:
    """Save the trainer's whole state as the resume point after `step`."""
    path = osp.abspath(osp.join(ckpt_dir, f"step-{step:09d}"))
    rng = trainer.rng_state()
    if trainer.dp is not None and not trainer.dp.is_main:
        trainer.dp.barrier()
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "step": int(step),
        "params": _cpu_tree(trainer.params),
        "occ": {"occs": trainer.occ.occs.cpu(), "binaries": trainer.occ.binaries.cpu()},
        "opt": {"count": int(trainer.opt_count), "adam": trainer.adam_state()},
        "rng": rng,
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if trainer.dp is not None:
        trainer.dp.barrier()
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest N of the step-N entries in ckpt_dir, or None."""
    if not osp.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(STEP_NAME.match, os.listdir(ckpt_dir)) if m]
    return max(steps) if steps else None


def strip_camera_opt(params: dict) -> dict:
    """An eval run's load: every camera_opt leaf zeroed."""
    out = dict(params)
    if "camera_opt" in out:
        def zero(t):
            return {k: zero(v) for k, v in t.items()} if isinstance(t, dict) else torch.zeros_like(t)

        out["camera_opt"] = zero(out["camera_opt"])
    return out


def _payload(ckpt_dir: str, step: Optional[int]) -> dict:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints found in {ckpt_dir}")
    path = osp.join(ckpt_dir, f"step-{step:09d}")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None, strip_cameras: bool = False):
    """(step, params, occ dict) of step `step`, by default the latest."""
    payload = _payload(ckpt_dir, step)
    params = payload["params"]
    if strip_cameras:
        params = strip_camera_opt(params)
    return int(payload["step"]), params, payload["occ"]


def load_checkpoint_full(ckpt_dir: str, step: Optional[int] = None):
    """The exact-resume load: (step, params, occ, opt | None, rng | None)."""
    payload = _payload(ckpt_dir, step)
    return (int(payload["step"]), payload["params"], payload["occ"],
            payload.get("opt"), payload.get("rng"))


def restore_into_state(trainer, params: dict, occ: dict, step: int, opt: Optional[dict] = None,
                       rng=None) -> bool:
    """Graft loaded tensors into the trainer's fresh state: only the keys of
    the fresh tree, each where its shape matches (new or missing keys keep
    their init, as load_state_dict(strict=False)); the grid; step + 1 as
    the next step. With `opt` and `rng` (load_checkpoint_full) Adam and the
    generator continue where the save left off; Adam's state that does not
    fit the current optimizer (another config) leaves it fresh. Returns
    whether Adam's state was restored."""

    def merge(live: dict, loaded):
        for k, v in live.items():
            if not isinstance(loaded, dict) or k not in loaded:
                continue
            if isinstance(v, dict):
                merge(v, loaded[k])
            elif tuple(loaded[k].shape) == tuple(v.shape):
                with torch.no_grad():
                    v.copy_(loaded[k].to(v.device, v.dtype))

    merge(trainer.params, params)
    dev = trainer.occ.occs.device
    trainer.occ = OccGridState(occs=occ["occs"].to(dev).clone(),
                               binaries=occ["binaries"].to(dev).clone())
    trainer.step_count = int(step) + 1
    if rng is not None:
        trainer.set_rng_state(rng)
    return opt is not None and trainer.load_adam_state(opt["adam"], opt["count"])
