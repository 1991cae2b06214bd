"""Camera model and differentiable ray generation. Port of
lsenerf_tpu/cameras/cameras.py: no half-pixel offset, one shared
intrinsic, OpenGL directions (x-cx)/fx, -(y-cy)/fy, -1, pixel_area from
+1-pixel offset rays, and the Newton undistort of OpenCV's radial and
tangential distortion where a camera has distortion parameters."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from lsenerf_tpu_torch.cameras.rays import RayBundle
from lsenerf_tpu_torch.ops.lie import mm


@dataclass
class Cameras:
    """A batch of pinhole cameras sharing one intrinsic."""

    camera_to_worlds: torch.Tensor  # (n, 3, 4) OpenGL c2w
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    distortion_params: Optional[torch.Tensor] = None  # (6,) k1 k2 k3 k4 p1 p2
    times: Optional[torch.Tensor] = None  # (n,)

    def __len__(self) -> int:
        return self.camera_to_worlds.shape[0]

    def to(self, device) -> "Cameras":
        return dataclasses.replace(
            self,
            camera_to_worlds=self.camera_to_worlds.to(device),
            distortion_params=None if self.distortion_params is None
            else self.distortion_params.to(device),
            times=None if self.times is None else self.times.to(device),
        )


def _distortion_residual_and_jacobian(x, y, xd, yd, p):
    """OpenCV distortion residual and its Jacobian (nerfstudio
    camera_utils._compute_residual_and_jacobian)."""
    k1, k2, k3, k4, p1, p2 = p[0], p[1], p[2], p[3], p[4], p[5]
    r = x * x + y * y
    d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))
    fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
    fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd
    d_r = k1 + r * (2.0 * k2 + r * (3.0 * k3 + r * 4.0 * k4))
    d_x = 2.0 * x * d_r
    d_y = 2.0 * y * d_r
    fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
    fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
    fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
    fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
    return fx, fy, fx_x, fx_y, fy_x, fy_y


def radial_and_tangential_undistort(coords: torch.Tensor, distortion_params: torch.Tensor,
                                    eps: float = 1e-3, num_iters: int = 10) -> torch.Tensor:
    """(..., 2) distorted normalised coordinates -> undistorted, by
    num_iters Newton steps (a step is skipped where |det J| <= eps)."""
    xd, yd = coords[..., 0], coords[..., 1]
    x, y = xd, yd
    for _ in range(num_iters):
        fx, fy, fx_x, fx_y, fy_x, fy_y = _distortion_residual_and_jacobian(
            x, y, xd, yd, distortion_params)
        denom = fy_x * fx_y - fx_x * fy_y
        ok = torch.abs(denom) > eps
        zero = torch.zeros_like(denom)
        x = x + torch.where(ok, (fx * fy_y - fy * fx_y) / denom, zero)
        y = y + torch.where(ok, (fy * fx_x - fx * fy_x) / denom, zero)
    return torch.stack([x, y], dim=-1)


def generate_rays(
    cams: Cameras,
    camera_indices: torch.Tensor,
    pixel_coords: torch.Tensor,
    c2w: Optional[torch.Tensor] = None,
) -> RayBundle:
    """World-space rays for (camera, pixel) pairs; pixel_coords (n, 2) are
    [row y, col x]."""
    if c2w is None:
        c2w = cams.camera_to_worlds[camera_indices]
    y = pixel_coords[..., 0].float()
    x = pixel_coords[..., 1].float()
    coord = torch.stack([(x - cams.cx) / cams.fx, -(y - cams.cy) / cams.fy], -1)
    coord_x = torch.stack([(x - cams.cx + 1) / cams.fx, -(y - cams.cy) / cams.fy], -1)
    coord_y = torch.stack([(x - cams.cx) / cams.fx, -(y - cams.cy + 1) / cams.fy], -1)
    coord_stack = torch.stack([coord, coord_x, coord_y], 0)  # (3, n, 2)
    if cams.distortion_params is not None:
        coord_stack = radial_and_tangential_undistort(coord_stack, cams.distortion_params)
    dirs_cam = torch.cat([coord_stack, -torch.ones_like(coord_stack[..., :1])], -1)
    rotation = c2w[..., :3, :3]  # (n, 3, 3)
    dirs_world = torch.einsum("knj,nij->kni", dirs_cam, rotation)
    norms = torch.linalg.norm(dirs_world, dim=-1, keepdim=True)
    dirs_world = dirs_world / norms
    directions = dirs_world[0]
    dx = torch.sqrt(((directions - dirs_world[1]) ** 2).sum(-1))
    dy = torch.sqrt(((directions - dirs_world[2]) ** 2).sum(-1))
    times = None if cams.times is None else cams.times[camera_indices][..., None]
    return RayBundle(
        origins=c2w[..., :3, 3],
        directions=directions,
        pixel_area=(dx * dy)[..., None],
        camera_indices=camera_indices[..., None].int(),
        times=times,
    )


def apply_correction_to_bundle(bundle: RayBundle, correction: torch.Tensor) -> RayBundle:
    """Per-ray (n, 3, 4) corrections: origins += t, directions <- R d."""
    origins = bundle.origins + correction[:, :3, 3]
    directions = mm(correction[:, :3, :3], bundle.directions[..., None])[..., 0]
    return bundle.replace(origins=origins, directions=directions)
