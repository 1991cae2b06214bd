"""Analytic synthetic scene: a normal-coloured sphere, orbiting cameras and
exact delta-log-gray event frames. Port of make_synthetic_scene and its
helpers from lsenerf_tpu/data/synthetic.py; the same arguments give the
same images, cameras and events."""

from __future__ import annotations

import numpy as np
import torch

from lsenerf_tpu_torch.cameras.cameras import Cameras
from lsenerf_tpu_torch.data.dataset import ColorDataset, EventFrameDataset

EPS = 1e-6
REC601 = np.array([0.2989, 0.5870, 0.1140], np.float32)


def look_at_c2w(eye: np.ndarray, target: np.ndarray, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """OpenGL-convention camera-to-world (camera looks down -z)."""
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    up = np.asarray(up, np.float64)
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -forward
    c2w[:3, 3] = eye
    return c2w[:3, :4].astype(np.float32)


def orbit_cameras(
    n: int, radius: float = 1.5, height: float = 0.4,
    h: int = 64, w: int = 64, focal: float = 80.0,
    t_span: float = 1e6, arc: float = 1.5 * np.pi,
) -> Cameras:
    angles = np.linspace(0.0, arc, n, endpoint=False)
    c2ws = np.stack([
        look_at_c2w(np.array([radius * np.cos(a), height, radius * np.sin(a)]), np.zeros(3))
        for a in angles
    ])
    times = np.linspace(0.0, t_span, n).astype(np.float32)
    return Cameras(
        camera_to_worlds=torch.from_numpy(c2ws),
        fx=focal, fy=focal, cx=w / 2.0, cy=h / 2.0, width=w, height=h,
        times=torch.from_numpy(times),
    )


def render_sphere_image(cam_c2w: np.ndarray, cams: Cameras, sphere_r: float = 0.5,
                        texture_freq: float = 0.0):
    """Analytic render of the normal-coloured sphere (white background)."""
    h, w = cams.height, cams.width
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dirs_cam = np.stack(
        [(xs - cams.cx) / cams.fx, -(ys - cams.cy) / cams.fy, -np.ones_like(xs, np.float64)],
        axis=-1,
    )
    R, o = cam_c2w[:3, :3], cam_c2w[:3, 3]
    d = dirs_cam @ R.T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    b = 2 * d @ o
    c = o @ o - sphere_r**2
    disc = b * b - 4 * c
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / 2, np.inf)
    hit &= t > 0
    t_safe = np.where(np.isfinite(t), t, 0.0)
    p = o[None, None] + t_safe[..., None] * d
    color = 0.5 + 0.45 * (p / sphere_r)
    if texture_freq > 0.0:
        phi = np.arctan2(p[..., 2], p[..., 0])
        theta = np.arccos(np.clip(p[..., 1] / sphere_r, -1.0, 1.0))
        tex = 0.5 + 0.5 * np.sin(texture_freq * phi) * np.sin(texture_freq * theta)
        color = color * (0.35 + 0.65 * tex)[..., None]
    img = np.ones((h, w, 3), np.float32)
    img[hit] = color[hit].astype(np.float32)
    return img


def make_synthetic_scene(
    n_cams: int = 12, h: int = 48, w: int = 48, focal: float = 60.0,
    e_thresh: float = 0.2, texture_freq: float = 0.0,
):
    """Returns (ColorDataset, EventFrameDataset); event frame i is the
    delta-log-gray between cameras i and i+1, stored as counts."""
    cams = orbit_cameras(n_cams, h=h, w=w, focal=focal)
    c2ws = cams.camera_to_worlds.numpy()
    images = np.stack([
        render_sphere_image(c2ws[i], cams, texture_freq=texture_freq) for i in range(n_cams)
    ])
    log_gray = np.log(images @ REC601 + EPS)
    eimgs = (log_gray[1:] - log_gray[:-1])[..., None] / e_thresh
    col = ColorDataset(
        images=images, cameras=cams, appearance_ids=np.arange(n_cams, dtype=np.int32)
    )
    evs = EventFrameDataset(
        eimgs=eimgs.astype(np.float32),
        cameras=Cameras(
            camera_to_worlds=cams.camera_to_worlds, fx=cams.fx, fy=cams.fy,
            cx=cams.cx, cy=cams.cy, width=cams.width, height=cams.height,
            times=cams.times,
        ),
        e_thresh=e_thresh,
        appearance_ids=np.arange(n_cams - 1, dtype=np.int32),
    )
    return col, evs
