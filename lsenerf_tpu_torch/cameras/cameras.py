"""Camera model and differentiable ray generation. Port of
lsenerf_tpu/cameras/cameras.py: no half-pixel offset, one shared
intrinsic, OpenGL directions (x-cx)/fx, -(y-cy)/fy, -1, pixel_area from
+1-pixel offset rays. Lens distortion is not ported yet (the synthetic
scene has none)."""

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
    times: Optional[torch.Tensor] = None  # (n,)

    def __len__(self) -> int:
        return self.camera_to_worlds.shape[0]

    def to(self, device) -> "Cameras":
        return dataclasses.replace(
            self,
            camera_to_worlds=self.camera_to_worlds.to(device),
            times=None if self.times is None else self.times.to(device),
        )


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
