"""Per-camera SO3xR3 pose deltas (the `ns` camera optimizer). Port of that
part of lsenerf_tpu/cameras/pose_opt.py; the spline and prev/next
optimizers are not ported yet."""

from __future__ import annotations

import torch

from lsenerf_tpu_torch.cameras import cameras as cam_lib
from lsenerf_tpu_torch.cameras.rays import RayBundle
from lsenerf_tpu_torch.ops import lie


def init_pose_deltas(num_cameras: int, device="cpu") -> dict:
    return {"pose_adjustment": torch.zeros((num_cameras, 6), device=device)}


def pose_correction(params: dict, indices, active, mode: str = "SO3xR3"):
    """(n,) camera indices -> (n, 3, 4) corrections; `active` is the 0/1
    delayed-activation gate (0 gives identity and zero gradient)."""
    if mode != "SO3xR3":
        raise NotImplementedError(f"camera-opt mode {mode!r} is not ported")
    return lie.exp_map_SO3xR3(params["pose_adjustment"][indices] * active)


def apply_pose_deltas_to_bundle(params: dict, bundle: RayBundle, active, mode="SO3xR3"):
    if mode == "off":
        return bundle
    corr = pose_correction(params, bundle.camera_indices[:, 0].long(), active, mode)
    return cam_lib.apply_correction_to_bundle(bundle, corr)


def activation_gate(step: int, scheme: str, delay_cnt: int) -> float:
    """0/1 gate of the delayed scheme: on when step > delay_cnt."""
    if scheme != "delayed":
        return 1.0
    return float(step > delay_cnt)
