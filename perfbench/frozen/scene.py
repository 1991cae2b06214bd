"""The repo's synthetic real-scale scene, made in memory on the device.

A frozen copy of the port's `data/synthetic.py` generator (a textured,
normal-coloured sphere seen by cameras on an orbit, with exact
delta-log-gray event frames), rewritten in torch so that 200 frames of
640x480 take well under a second on the card, and of what the CLI reads
back after `write_reference_scene(..., with_prevnext=True,
with_full_camera=True)`: the frames as 8-bit PNGs (so the images are
`uint8 / 255`), event counts as int16 over the scene's threshold,
consecutive frames as each event frame's prev and next cameras, the last
frame dropped and the last `n_val` usable frames held out. Nothing is
written to disk.

The scene does not depend on the seed: every seed trains on the same
scene, and draws its own weights and pixels.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

EPS = 1e-6
REC601 = (0.2989, 0.5870, 0.1140)


@dataclass
class Scene:
    """The scene as the parser returns it, as numpy arrays on the host:
    the train frames (n_train, h, w, 3) f32 in [0, 1], their
    camera-to-worlds (n_train, 3, 4) f32 and times; the event counts
    (n_evs, h, w, 1) int16, e_thresh, the prev/next camera-to-worlds and
    times; the dense trajectory (2 n_cams poses) for the spline's knots."""

    images: np.ndarray
    c2ws: np.ndarray
    times: np.ndarray
    eimgs: np.ndarray
    e_thresh: float
    prev_c2ws: np.ndarray
    next_c2ws: np.ndarray
    prev_times: np.ndarray
    next_times: np.ndarray
    full_c2ws: np.ndarray
    full_times: np.ndarray
    h: int
    w: int
    focal: float


def look_at_c2w(eye: np.ndarray, target: np.ndarray, up=(0.0, 1.0, 0.0)) -> np.ndarray:
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


def orbit(n: int, radius: float = 1.5, height: float = 0.4, t_span: float = 1e6,
          arc: float = 1.5 * np.pi):
    """(c2ws (n, 3, 4) f32, times (n,) f32) of n cameras on the orbit."""
    angles = np.linspace(0.0, arc, n, endpoint=False)
    c2ws = np.stack([look_at_c2w(np.array([radius * np.cos(a), height, radius * np.sin(a)]),
                                 np.zeros(3)) for a in angles])
    return c2ws, np.linspace(0.0, t_span, n).astype(np.float32)


def render_spheres(c2ws: torch.Tensor, h: int, w: int, focal: float, texture_freq: float,
                   sphere_r: float = 0.5) -> torch.Tensor:
    """(n, h, w, 3) f32 analytic renders of the sphere on a white ground,
    in float64 as the numpy generator computes them."""
    dev = c2ws.device
    n = c2ws.shape[0]
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float64),
                            torch.arange(w, device=dev, dtype=torch.float64), indexing="ij")
    cx, cy = w / 2.0, h / 2.0
    dirs_cam = torch.stack([(xs - cx) / focal, -(ys - cy) / focal, -torch.ones_like(xs)], -1)
    R = c2ws[:, :3, :3].double()
    o = c2ws[:, :3, 3].double()
    d = torch.einsum("hwj,nij->nhwi", dirs_cam, R)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    b = 2 * torch.einsum("nhwi,ni->nhw", d, o)
    c = (o * o).sum(-1)[:, None, None] - sphere_r ** 2
    disc = b * b - 4 * c
    hit = disc > 0
    t = torch.where(hit, (-b - torch.sqrt(torch.clamp(disc, min=0))) / 2,
                    torch.full_like(b, math.inf))
    hit &= t > 0
    t_safe = torch.where(torch.isfinite(t), t, torch.zeros_like(t))
    p = o[:, None, None, :] + t_safe[..., None] * d
    color = 0.5 + 0.45 * (p / sphere_r)
    if texture_freq > 0.0:
        phi = torch.atan2(p[..., 2], p[..., 0])
        theta = torch.arccos(torch.clamp(p[..., 1] / sphere_r, -1.0, 1.0))
        tex = 0.5 + 0.5 * torch.sin(texture_freq * phi) * torch.sin(texture_freq * theta)
        color = color * (0.35 + 0.65 * tex)[..., None]
    img = torch.ones((n, h, w, 3), dtype=torch.float32, device=dev)
    return torch.where(hit[..., None], color.float(), img)


def _quantile(x: torch.Tensor, q: float) -> float:
    """numpy's default (linear) quantile of a 1-d tensor of any size."""
    s = x.sort().values
    pos = q * (s.numel() - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, s.numel() - 1)
    return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))


def make_scene(n_cams: int, h: int, w: int, focal: float, texture_freq: float, n_val: int,
               e_thresh: float = 0.2, device="cuda", batch: int = 16) -> Scene:
    """The scene of `n_cams` frames of h x w (module doc), rendered on
    `device` `batch` frames at a time."""
    c2ws, times = orbit(n_cams)
    gpu_c2ws = torch.from_numpy(c2ws).to(device)
    rec = torch.tensor(REC601, dtype=torch.float32, device=device)
    img8 = torch.empty((n_cams, h, w, 3), dtype=torch.uint8, device=device)
    log_gray = torch.empty((n_cams, h, w), dtype=torch.float32, device=device)
    for i in range(0, n_cams, batch):
        img = render_spheres(gpu_c2ws[i:i + batch], h, w, focal, texture_freq)
        log_gray[i:i + batch] = torch.log(img @ rec + EPS)
        img8[i:i + batch] = torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8)
    raw_delta = log_gray[1:] - log_gray[:-1]
    # write_reference_scene's threshold: half the 90th percentile of the
    # moving pixels' deltas where e_thresh would zero 99% of the events
    e_eff = e_thresh
    counts = torch.round(raw_delta / e_eff)
    if (counts != 0).float().mean() < 0.01:
        moving = raw_delta.abs()[raw_delta.abs() > 1e-6]
        if moving.numel():
            e_eff = float(max(_quantile(moving.double(), 0.9) / 2.0, 1e-6))
            counts = torch.round(raw_delta / e_eff)
    usable = n_cams - 1  # the parser drops the last frame
    train = np.arange(usable - n_val) if n_val else np.arange(usable)
    images = (img8[torch.from_numpy(train).to(device)].float() / 255.0).cpu().numpy()
    full_c2ws, full_times = orbit(2 * n_cams)
    return Scene(
        images=images, c2ws=c2ws[train], times=times[train],
        eimgs=counts.to(torch.int16)[..., None].cpu().numpy(), e_thresh=e_eff,
        prev_c2ws=c2ws[:-1], next_c2ws=c2ws[1:], prev_times=times[:-1], next_times=times[1:],
        full_c2ws=full_c2ws, full_times=full_times, h=h, w=w, focal=focal)
