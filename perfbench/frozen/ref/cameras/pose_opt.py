"""Camera-pose optimizers. Port of lsenerf_tpu/cameras/pose_opt.py:
per-camera SO3xR3 or SE3 deltas (`ns`), independent delta sets for the
prev and next cameras (`prevnext`), and the continuous-time spline whose
learnable knots give the RGB poses, the 4 exposure poses of deblur and,
through the RGB-to-event extrinsic dM, the event poses (`spline`).

The delayed activation is a 0/1 gate: deltas are scaled by it (0 gives
identity and zero gradient), the spline's parameters have only their
gradient gated, so an inactive spline still gives its initial trajectory."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from perfbench.frozen.ref.cameras import cameras as cam_lib
from perfbench.frozen.ref.cameras.rays import RayBundle
from perfbench.frozen.ref.ops import interp, lie


def init_pose_deltas(num_cameras: int, device="cpu") -> dict:
    return {"pose_adjustment": torch.zeros((num_cameras, 6), device=device)}


def pose_correction(params: dict, indices, active, mode: str = "SO3xR3"):
    """(n,) camera indices -> (n, 3, 4) corrections; `active` is the 0/1
    delayed-activation gate (0 gives identity and zero gradient)."""
    deltas = params["pose_adjustment"][indices] * active
    if mode == "SE3":
        return lie.exp_map_SE3(deltas)
    return lie.exp_map_SO3xR3(deltas)


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


# -- prev/next pairs ("prevnext") ---------------------------------------------


def init_prevnext_deltas(num_cameras: int, device="cpu") -> dict:
    return {
        "prev": init_pose_deltas(num_cameras, device),
        "next": init_pose_deltas(num_cameras, device),
    }


def apply_prevnext_to_bundles(params: dict, prev_bundle: RayBundle, next_bundle: RayBundle,
                              active, mode: str = "SO3xR3"):
    """Each bundle gets its own delta set."""
    if mode == "off":
        return prev_bundle, next_bundle
    return (
        apply_pose_deltas_to_bundle(params["prev"], prev_bundle, active, mode),
        apply_pose_deltas_to_bundle(params["next"], next_bundle, active, mode),
    )


# -- continuous-time spline ("spline") ----------------------------------------


@dataclass(frozen=True)
class SplineStatic:
    """The spline's fixed data, on the trainer's device."""

    ctrl_ts: torch.Tensor  # (m,) f32 knot times
    dM: Optional[torch.Tensor]  # (4, 4) rigid RGB -> event extrinsic, or None
    exp_t: float = 30000.0  # exposure time
    n_deblur_rays: int = 4  # poses sampled per exposure


def init_spline(c2ws: np.ndarray, cam_ts: np.ndarray, control_pnt_factor: int = 1,
                dM: Optional[np.ndarray] = None, exp_t: float = 30000.0, device="cpu"):
    """Knots at `control_pnt_factor` x the camera rate, placed on the camera
    trajectory by scipy's Slerp (rotation) and interp1d (translation) in
    float64, as learnable (m, 6) tangents. Returns (params, SplineStatic)."""
    from scipy.interpolate import interp1d
    from scipy.spatial.transform import Rotation, Slerp

    c2ws = np.asarray(c2ws, dtype=np.float64)
    cam_ts = np.asarray(cam_ts, dtype=np.float64).squeeze()

    rot_interp = Slerp(cam_ts, Rotation.from_matrix(c2ws[:, :3, :3]))
    trans_interp = interp1d(cam_ts, c2ws[:, :3, 3], axis=0, kind="linear")

    max_err = np.abs(rot_interp(cam_ts[0]).as_matrix() - c2ws[0][:3, :3]).max()
    if max_err >= 1e-5:
        raise ValueError(f"c2ws are mirror transforms (err {max_err})")

    ctrl_dts = (np.diff(cam_ts) / control_pnt_factor).reshape(-1, 1)
    i_s = np.arange(0, control_pnt_factor).reshape(1, -1)
    ctrl_ts = np.concatenate(
        [(cam_ts.reshape(-1, 1)[:-1] + ctrl_dts * i_s).reshape(-1), cam_ts[-1:]]
    ).astype(np.float32)

    ctrl_c2ws = np.concatenate(
        [rot_interp(ctrl_ts).as_matrix(), trans_interp(ctrl_ts)[..., None]], axis=-1
    )
    params = {
        "ctrl_tangents": torch.from_numpy(lie.matrix_to_tangent_vector(ctrl_c2ws)).to(device),
        "scale": torch.ones((1,), device=device),
    }
    static = SplineStatic(
        ctrl_ts=torch.from_numpy(ctrl_ts).to(device),
        dM=None if dM is None else torch.as_tensor(np.asarray(dM, np.float32)).to(device),
        exp_t=float(exp_t),
    )
    return params, static


def spline_rgb_c2w(params: dict, static: SplineStatic, times: torch.Tensor, active):
    """RGB camera poses (k, 3, 4) at `times`."""
    tangents = _gate_params(params["ctrl_tangents"], active)
    return interp.interpolate_c2w(tangents, static.ctrl_ts, times)


def spline_evs_c2w(params: dict, static: SplineStatic, times: torch.Tensor, active):
    """Event camera poses: the RGB spline's pose @ dM, with dM's baseline
    (its translation) times the learnable scale."""
    if static.dM is None:
        raise ValueError("the event spline needs the RGB -> event extrinsic dM")
    rgb = spline_rgb_c2w(params, static, times, active)
    dM = static.dM
    scale = _gate_params(params["scale"], active)
    dM_scaled = torch.cat([torch.cat([dM[:3, :3], dM[:3, 3:4] * scale], 1), dM[3:]], 0)
    return lie.mm(rgb, dM_scaled.expand(rgb.shape[0], 4, 4))


def spline_deblur_c2w(params: dict, static: SplineStatic, cam_ts: torch.Tensor, active):
    """n_deblur_rays poses spread evenly over the exposure around each time:
    cam_ts (n, 1) -> (n * 4, 3, 4), the 4 poses of a camera together."""
    st_t = cam_ts - static.exp_t / 2.0
    delta_t = static.exp_t / (static.n_deblur_rays - 1)
    t_steps = delta_t * torch.arange(static.n_deblur_rays, dtype=cam_ts.dtype, device=cam_ts.device)
    all_ts = (st_t + t_steps[None]).reshape(-1)
    return spline_rgb_c2w(params, static, all_ts, active)


def _gate_params(p: torch.Tensor, active) -> torch.Tensor:
    """active 1: p with its gradient; active 0: p's value, zero gradient."""
    return active * p + (1.0 - active) * p.detach()
